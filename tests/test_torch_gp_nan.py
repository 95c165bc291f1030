"""A Cholesky that fails on the GP path gives NaN, as in JAX.

``jnp.linalg.cholesky`` returns a NaN lower triangle for a matrix that is
not positive definite, where ``torch.linalg.cholesky`` raises. The port
routes every GP-path factorization through ``ops.linalg.cholesky``, which
keeps JAX's convention, so a training run whose Kuu loses definiteness
sees a NaN loss and does not die. The same numpy inputs go to both
packages: two equal inducing points (or GP inputs) at jitter 0 make Kuu
singular, and both sides must give NaN where JAX does. float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxfusion_tpu as mj
from mxfusion_tpu.common import config as jconfig
from mxfusion_tpu.components.distributions import GaussianProcess as JGP
from mxfusion_tpu.components.distributions.gp.kernels import RBF as JRBF
from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive
from mxfusion_tpu.inference import (MAP as JMAP,
                                    GradBasedInference as JInference,
                                    TransferInference as JTransfer,
                                    VariableEnv as JEnv,
                                    create_executor as jcreate_executor)
from mxfusion_tpu.modules import SVGPRegression as JSVGP
from mxfusion_tpu.modules.gp_modules import svgp_regression as jsvgp

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.distributions import GaussianProcess
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (MAP, GradBasedInference,
                                          TransferInference, VariableEnv,
                                          create_executor)
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.modules.gp_modules import svgp_regression as tsvgp
from mxfusion_tpu_torch.ops import linalg
from mxfusion_tpu_torch.util.carryover import load_state


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port runs on the card unless the CPU is asked for: these tests
    ask for it, and put the previous default back afterwards."""
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


def _f64(fn):
    old = jconfig.get_default_dtype()
    jconfig.set_default_dtype("float64")
    try:
        return fn()
    finally:
        jconfig.set_default_dtype(old)


def _data(seed, N, D, M):
    """Data, and inducing points whose first two rows are equal."""
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 4
    Y = np.sin(2 * X[:, :1]) + rng.standard_normal((N, 1)) * 0.1
    Z0 = rng.random((M, D)) * 4
    Z0[1] = Z0[0]
    return X, Y, Z0


def _model(pkg, Positive, Rbf, Svgp, Z0, whitened):
    D = Z0.shape[1]
    m = pkg.Model()
    m.n = pkg.Variable()
    m.X = pkg.Variable(shape=(m.n, D))
    m.noise_var = pkg.Variable(transformation=Positive(), initial_value=0.1)
    m.Y = Svgp.define_variable(
        X=m.X, kernel=Rbf(input_dim=D, variance=1.0, lengthscale=0.8,
                          dtype="float64"),
        noise_var=m.noise_var, shape=(m.n, 1), whitened=whitened,
        jitter=0.0, dtype="float64",
        inducing_inputs=pkg.Variable(shape=Z0.shape, initial_value=Z0))
    return m


def _pair(X, Y, Z0, whitened):
    """The JAX inference and the port's, loaded with the JAX state."""
    def jax_side():
        jm = _model(mj, JPositive, JRBF, JSVGP, Z0, whitened)
        jinf = JInference(JMAP(model=jm, observed=[jm.X, jm.Y]),
                          dtype="float64")
        jinf.initialize(X=X, Y=Y, key=jax.random.PRNGKey(0))
        return jinf
    jinf = _f64(jax_side)
    tm = _model(mt, PositiveTransformation, RBF, SVGPRegression, Z0,
                whitened)
    tinf = GradBasedInference(MAP(model=tm, observed=[tm.X, tm.Y]),
                              dtype="float64", device="cpu")
    tinf.initialize(X=X, Y=Y)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    return jinf, tinf


def test_cholesky_follows_jax_convention():
    """NaN lower triangle and 0 above for a matrix that is not positive
    definite, per matrix of a stack; the factor of ½(A + Aᵀ)."""
    A = np.stack([np.ones((3, 3)), np.diag([4.0, 1.0, 9.0])])
    A[1, 0, 2] = 0.5
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    got = linalg.cholesky(torch.as_tensor(A)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0][np.tril_indices(3)]).all()
    assert (got[0][np.triu_indices(3, 1)] == 0).all()
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12, atol=1e-12)
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(torch.as_tensor(A))


def test_gaussian_process_log_pdf_nan_as_jax():
    """``GaussianProcess.log_pdf`` on two equal inputs at jitter 0."""
    rng = np.random.default_rng(4)
    Z = rng.random((1, 6, 3)) * 3
    Z[0, 1] = Z[0, 0]
    U = rng.standard_normal((1, 6, 2))
    ls, var = np.full((1, 3), 1.3), np.full((1, 1), 0.8)
    out = []
    for GP, Rbf, as_array, Env in (
            (GaussianProcess, RBF, torch.as_tensor, VariableEnv),
            (JGP, JRBF, jnp.asarray, JEnv)):
        kern = Rbf(input_dim=3, ARD=True)
        gp = GP(X=0.0, kernel=kern, jitter=0.0)
        gp._generate_outputs(shape=(6, 2))
        env = Env({gp.X.uuid: as_array(Z),
                   gp.random_variable.uuid: as_array(U),
                   kern.lengthscale.uuid: as_array(ls),
                   kern.variance.uuid: as_array(var)})
        out.append(np.asarray(gp.log_pdf(env)))
    assert np.isnan(out[1]).all()
    np.testing.assert_array_equal(np.isnan(out[0]), np.isnan(out[1]))


@pytest.mark.parametrize("whitened", [False, True],
                         ids=["standard", "whitened"])
@pytest.mark.parametrize("N", [20, 64], ids=["narrow", "wide"])
def test_svgp_bound_nan_as_jax(whitened, N):
    """The SVGP bound and its gradients: NaN in both packages, not an
    exception in the port (N = 64 ≥ 4M takes the materialized L⁻¹)."""
    X, Y, Z0 = _data(5, N, 2, 8)
    jinf, tinf = _pair(X, Y, Z0, whitened)
    jex = jcreate_executor(jinf.inference_algorithm, jinf.params)
    jfixed = dict(jinf.params.fixed_params())
    jl = float(_f64(lambda: jex(dict(jinf.params.trainable_params()),
                                jfixed, [X, Y], jax.random.PRNGKey(0))[1]))
    ex = create_executor(tinf.inference_algorithm, tinf.params)
    train = {k: v.clone().requires_grad_(True)
             for k, v in tinf.params.trainable_params().items()}
    loss = ex(train, tinf.params.fixed_params(), [X, Y],
              torch.Generator().manual_seed(0))[1]
    loss.backward()
    assert np.isnan(jl) and bool(torch.isnan(loss))
    assert all(bool(torch.isnan(t.grad).any()) for t in train.values()
               if t.grad is not None)


@pytest.mark.parametrize("alg", ["mean_variance", "sampling"])
def test_svgp_prediction_nan_as_jax(alg):
    """``SVGPRegressionMeanVariancePrediction`` (the batched Cholesky of
    Kuu and S) and ``SVGPRegressionSamplingPrediction`` with the full
    covariance (its Cholesky of the predictive covariance), jitter 0."""
    X, Y, Z0 = _data(11, 50, 2, 6)
    jinf, tinf = _pair(X, Y, Z0, whitened=False)
    Xt = np.random.default_rng(12).random((9, 2)) * 4
    draws = np.random.default_rng(13).standard_normal(3 * 9)
    outs = []
    for pkg, model, Transfer, params, extra in (
            (jsvgp, jinf.graphs[0], JTransfer, jinf.params,
             {"key": jax.random.PRNGKey(0)}),
            (tsvgp, tinf.graphs[0], TransferInference, tinf.params,
             {"generator": torch.Generator()})):
        mod = model.Y.factor
        if alg == "sampling":
            Fixed = mj.components.distributions.FixedRandomGenerator \
                if pkg is jsvgp else \
                mt.components.distributions.FixedRandomGenerator
            a = pkg.SVGPRegressionSamplingPrediction(
                mod._module_graph, mod._extra_graphs[0], [model.X],
                rand_gen=Fixed(draws), diagonal_variance=False, jitter=0.0)
            a.num_samples = 3
        else:
            a = pkg.SVGPRegressionMeanVariancePrediction(
                mod._module_graph, mod._extra_graphs[0], [model.X],
                jitter=0.0)
        a.target_variables = [model.Y.uuid]
        run = Transfer(a, infr_params=params)
        res = _f64(lambda: run.run(X=Xt, **extra)[0])
        outs.append([np.asarray(r) for r in
                     (res if isinstance(res, tuple) else (res,))])
    for want, got in zip(*outs):
        assert np.isnan(want).all()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
