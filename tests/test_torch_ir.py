"""The port's model IR, univariate Normal, bijectors and GP distributions
against the JAX package, in float64 on the same inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mxfusion_tpu as mj
from mxfusion_tpu.components.distributions import (
    Normal as JNormal, FixedRandomGenerator as JFixed,
    GaussianProcess as JGP, ConditionalGaussianProcess as JCGP)
from mxfusion_tpu.components.distributions.gp.kernels import RBF as JRBF
from mxfusion_tpu.components.functions.operators import \
    broadcast_to as jbroadcast_to
from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive
from mxfusion_tpu.inference import VariableEnv as JEnv

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.components.distributions import (
    Normal, FixedRandomGenerator, GaussianProcess, ConditionalGaussianProcess)
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import VariableEnv

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("rv_shape,param_shape", [
    ((1, 7, 1), (1, 1)), ((3, 5, 2), (3, 5, 2)), ((2, 4, 1), (1, 1))])
def test_normal_log_pdf_matches_jax(rv_shape, param_shape):
    rng = np.random.default_rng(0)
    rv = rng.standard_normal(rv_shape)
    mean = rng.standard_normal(param_shape)
    variance = rng.random(param_shape) + 0.1
    m, mm = Normal(mean=0.0, variance=1.0), JNormal(mean=0.0, variance=1.0)
    m._generate_outputs(shape=rv_shape[1:])
    mm._generate_outputs(shape=rv_shape[1:])
    env = VariableEnv({m.mean.uuid: torch.as_tensor(mean),
                       m.variance.uuid: torch.as_tensor(variance),
                       m.random_variable.uuid: torch.as_tensor(rv)})
    jenv = JEnv({mm.mean.uuid: jnp.asarray(mean),
                 mm.variance.uuid: jnp.asarray(variance),
                 mm.random_variable.uuid: jnp.asarray(rv)})
    lp = m.log_pdf(env)
    np.testing.assert_allclose(lp.numpy(), np.asarray(mm.log_pdf(jenv)),
                               **TOL)
    assert lp.shape[0] == rv_shape[0]


def test_normal_draw_with_fixed_draws_matches_jax():
    draws = np.random.default_rng(1).standard_normal(12)
    mean, variance = np.full((1, 1), 0.5), np.full((1, 1), 2.0)
    m = Normal(mean=0.0, variance=1.0, rand_gen=FixedRandomGenerator(draws),
               dtype="float64")
    mm = JNormal(mean=0.0, variance=1.0, rand_gen=JFixed(draws),
                 dtype="float64")
    m._generate_outputs(shape=(3, 2))
    mm._generate_outputs(shape=(3, 2))
    env = VariableEnv({m.mean.uuid: torch.as_tensor(mean),
                       m.variance.uuid: torch.as_tensor(variance)})
    jenv = JEnv({mm.mean.uuid: jnp.asarray(mean),
                 mm.variance.uuid: jnp.asarray(variance)})
    x = m.draw_samples(env, torch.Generator(), num_samples=2)
    xj = mm.draw_samples(jenv, None, num_samples=2)
    assert x.shape == (2, 3, 2)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **TOL)
    assert Normal.support == "real"


def test_positive_transformation_round_trip_matches_jax():
    x = np.concatenate([np.linspace(-30.0, 30.0, 41),
                        np.random.default_rng(2).standard_normal(9)])
    t, tj = PositiveTransformation(), JPositive()
    y = t.transform(torch.as_tensor(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(tj.transform(
        jnp.asarray(x))), **TOL)
    pos = y.numpy()[y.numpy() > 1e-8]
    # numpy path (initial values) and tensor path agree with JAX's
    np.testing.assert_allclose(t.inverse_transform(pos),
                               tj.inverse_transform(pos), **TOL)
    np.testing.assert_allclose(
        t.inverse_transform(torch.as_tensor(pos)).numpy(),
        np.asarray(tj.inverse_transform(jnp.asarray(pos))), **TOL)
    back = t.inverse_transform(t.transform(torch.as_tensor(x[x > -15])))
    np.testing.assert_allclose(back.numpy(), x[x > -15], rtol=1e-9,
                               atol=1e-12)


def _linreg_model(pkg, NormalCls, bcast, Positive, N):
    m = pkg.Model()
    m.mu = NormalCls.define_variable(mean=0.0, variance=100.0, shape=(1,))
    m.s = pkg.Variable(transformation=Positive(), initial_value=5.0)
    m.y = NormalCls.define_variable(mean=bcast(m.mu, (N, 1)),
                                    variance=bcast(m.s, (N, 1)),
                                    shape=(N, 1))
    return m


def test_factor_graph_log_pdf_matches_jax():
    """The graph interpreter: constants, broadcast_to, two Normals."""
    N = 6
    rng = np.random.default_rng(3)
    y = rng.standard_normal((1, N, 1)) + 3.0
    mu, s = rng.standard_normal((2, 1)), rng.random((2, 1)) + 0.5
    m = _linreg_model(mt, Normal, broadcast_to, PositiveTransformation, N)
    mm = _linreg_model(mj, JNormal, jbroadcast_to, JPositive, N)

    def env_of(model, as_array, Env):
        env = Env({model.y.uuid: as_array(y), model.mu.uuid: as_array(mu),
                   model.s.uuid: as_array(s)})
        for v in model.get_constants():
            env[v.uuid] = as_array(np.reshape(v.constant, (1, 1)))
        return env

    lp = m.log_pdf(env_of(m, torch.as_tensor, VariableEnv))
    lpj = mm.log_pdf(env_of(mm, jnp.asarray, JEnv))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lpj), **TOL)
    assert [type(f).__name__ for f in m.ordered_factors] == \
        [type(f).__name__ for f in mm.ordered_factors]


@pytest.mark.parametrize("jitter", [0.0, 1e-6])
def test_gp_distributions_log_pdf_match_jax(jitter):
    rng = np.random.default_rng(4)
    Nz, Nx, D = 6, 4, 3
    Z = rng.random((1, Nz, D)) * 3
    X = rng.random((1, Nx, D)) * 3
    U = rng.standard_normal((1, Nz, 2))
    F = rng.standard_normal((1, Nx, 2))
    ls, var = np.full((1, D), 1.3), np.full((1, 1), 0.8)
    out = []
    for GP, CGP, Rbf, as_array, Env in (
            (GaussianProcess, ConditionalGaussianProcess, RBF,
             torch.as_tensor, VariableEnv),
            (JGP, JCGP, JRBF, jnp.asarray, JEnv)):
        kern = Rbf(input_dim=D, ARD=True)
        gp = GP(X=0.0, kernel=kern, jitter=jitter + 1e-8)
        gp._generate_outputs(shape=(Nz, 2))
        cgp = CGP(X=0.0, X_cond=0.0, Y_cond=0.0, kernel=kern, jitter=1e-6)
        cgp._generate_outputs(shape=(Nx, 2))
        env = Env({gp.X.uuid: as_array(Z), gp.random_variable.uuid:
                   as_array(U), cgp.X.uuid: as_array(X),
                   cgp.X_cond.uuid: as_array(Z), cgp.Y_cond.uuid:
                   as_array(U), cgp.random_variable.uuid: as_array(F),
                   kern.lengthscale.uuid: as_array(ls),
                   kern.variance.uuid: as_array(var)})
        out.append((np.asarray(gp.log_pdf(env)),
                    np.asarray(cgp.log_pdf(env))))
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
