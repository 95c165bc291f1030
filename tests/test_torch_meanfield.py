"""Mean-field (ADVI-style) SVI against the JAX package.

Both packages build the same model and call ``create_Gaussian_meanfield``;
the JAX package initializes the state, ``util.carryover.load_state``
moves it into the port's store by name path, and both draw the same
noise: each posterior factor gets a ``FixedRandomGenerator`` over its own
numpy buffer, and the JAX loop runs eagerly (``debug=True``) so that
both consume the buffers step by step. float64 throughout. The goldens
of BASELINE ladder configs 1 and 2 are reproduced from the draws that
the JAX run takes from its key."""
import contextlib
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxfusion_tpu as mj
from mxfusion_tpu.common import config as jconfig
from mxfusion_tpu.components import distributions as jdist
from mxfusion_tpu.components.distributions.random_gen import \
    FixedRandomGenerator as JFixed
from mxfusion_tpu.components.functions import operators as jops
from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive
from mxfusion_tpu.inference import (
    GradBasedInference as JInference,
    StochasticVariationalInference as JSVI,
    create_Gaussian_meanfield as jmeanfield)

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.common.exceptions import InferenceError
from mxfusion_tpu_torch.components import distributions as tdist
from mxfusion_tpu_torch.components.distributions.random_gen import \
    FixedRandomGenerator
from mxfusion_tpu_torch.components.functions import operators as tops
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference, create_executor,
    create_Gaussian_meanfield)
from mxfusion_tpu_torch.util.carryover import load_state, name_paths

GOLDENS = str(Path(__file__).parent / "goldens" / "golden_{}.npz")


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu_in_float64():
    """The port runs on the card unless the CPU is asked for: these tests
    ask for it, with float64 factors, and put the previous defaults back
    afterwards."""
    old = tconfig.set_default_device("cpu")
    old_dtype = tconfig.get_default_dtype()
    tconfig.set_default_dtype("float64")
    yield
    tconfig.set_default_dtype(old_dtype)
    tconfig.set_default_device(old)


@contextlib.contextmanager
def jax_f64():
    old = jconfig.get_default_dtype()
    jconfig.set_default_dtype("float64")
    try:
        yield
    finally:
        jconfig.set_default_dtype(old)


J = SimpleNamespace(pkg=mj, dist=jdist, ops=jops, Positive=JPositive,
                    meanfield=jmeanfield, Fixed=JFixed)
T = SimpleNamespace(pkg=mt, dist=tdist, ops=tops,
                    Positive=PositiveTransformation,
                    meanfield=create_Gaussian_meanfield,
                    Fixed=FixedRandomGenerator)


# ---------------------------------------------------------------------
# the models: (model, observed variables, data by name), built alike in
# either package
# ---------------------------------------------------------------------

def ppca(P, N=60, K=2, D=5):
    """BASELINE config 1 (tests/goldens/configs.py:48-77)."""
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((K, D))
    z_true = rng.standard_normal((N, K))
    x = z_true @ w_true + rng.standard_normal((N, D)) * 0.1
    m = P.pkg.Model()
    m.w = P.pkg.Variable(shape=(K, D),
                         initial_value=rng.standard_normal((K, D)) * 0.1)
    m.z = P.dist.Normal.define_variable(
        mean=P.ops.broadcast_to(P.pkg.Variable(value=0.), (N, K)),
        variance=P.ops.broadcast_to(P.pkg.Variable(value=1.), (N, K)),
        shape=(N, K))
    m.x_mean = P.ops.dot(m.z, m.w)
    m.noise = P.pkg.Variable(transformation=P.Positive(), initial_value=0.1)
    m.x = P.dist.Normal.define_variable(
        mean=m.x_mean, variance=P.ops.broadcast_to(m.noise, (N, D)),
        shape=(N, D))
    return m, [m.x], {"x": x}


def linreg(P, N=80, D=3):
    """BASELINE config 2 (tests/goldens/configs.py:80-111)."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((N, D))
    y = X @ np.array([[1.5], [-0.7], [0.3]]) + \
        rng.standard_normal((N, 1)) * 0.1
    m = P.pkg.Model()
    m.X = P.pkg.Variable(shape=(N, D))
    m.w = P.dist.Normal.define_variable(
        mean=P.ops.broadcast_to(P.pkg.Variable(value=0.), (D, 1)),
        variance=P.ops.broadcast_to(P.pkg.Variable(value=1.), (D, 1)),
        shape=(D, 1))
    m.f = P.ops.dot(m.X, m.w)
    m.noise = P.pkg.Variable(transformation=P.Positive(), initial_value=0.1)
    m.y = P.dist.Normal.define_variable(
        mean=m.f, variance=P.ops.broadcast_to(m.noise, (N, 1)), shape=(N, 1))
    return m, [m.X, m.y], {"X": X, "y": y}


def gamma_exponential(P, N=40):
    y = np.random.default_rng(2).exponential(1.0 / 1.7, (N, 1))
    m = P.pkg.Model()
    m.tau = P.dist.Gamma.define_variable(alpha=2.0, beta=2.0, shape=(1,))
    m.y = P.dist.Exponential.define_variable(
        rate=P.ops.broadcast_to(m.tau, (N, 1)), shape=(N, 1))
    return m, [m.y], {"y": y}


def beta_bernoulli(P, N=40):
    y = (np.random.default_rng(3).random((N, 1)) < 0.3).astype(np.float64)
    m = P.pkg.Model()
    m.p = P.dist.Beta.define_variable(alpha=2.0, beta=2.0, shape=(1,))
    m.y = P.dist.Bernoulli.define_variable(
        prob_true=P.ops.broadcast_to(m.p, (N, 1)), shape=(N, 1))
    return m, [m.y], {"y": y}


def dirichlet_categorical(P, N=60, K=4):
    y = np.random.default_rng(4).choice(
        K, size=(N, 1), p=[0.5, 0.25, 0.15, 0.1]).astype(np.float64)
    m = P.pkg.Model()
    m.p = P.dist.Dirichlet.define_variable(alpha=np.full(K, 2.0),
                                           shape=(K,))
    m.y = P.dist.Categorical.define_variable(
        log_prob=P.ops.log(P.ops.broadcast_to(m.p, (N, K))), num_classes=K,
        shape=(N, 1))
    return m, [m.y], {"y": y}


def normal_with_gamma_variance(P, N=30, with_tau=True):
    """The latent mean of a Normal likelihood under a wide Normal prior,
    and (``with_tau``) its variance as a Gamma latent: every input of
    the priors and of the likelihood is unnamed."""
    y = np.random.default_rng(5).standard_normal((N, 1)) * 2.0 + 3.0
    m = P.pkg.Model()
    m.mu = P.dist.Normal.define_variable(mean=0., variance=100., shape=(1,))
    if with_tau:
        m.tau = P.dist.Gamma.define_variable(alpha=2.0, beta=0.5,
                                             shape=(1,))
        variance = P.ops.broadcast_to(m.tau, (N, 1))
    else:
        m.s = P.pkg.Variable(transformation=P.Positive(), initial_value=5.)
        variance = P.ops.broadcast_to(m.s, (N, 1))
    m.y = P.dist.Normal.define_variable(
        mean=P.ops.broadcast_to(m.mu, (N, 1)), variance=variance,
        shape=(N, 1))
    return m, [m.y], {"y": y}


# ---------------------------------------------------------------------
# one model in both packages
# ---------------------------------------------------------------------

def latents(q):
    """The posterior's random variables (of either package), by name."""
    return sorted((v for v in q.variables.values()
                   if v.type.name == "RANDVAR"), key=lambda v: v.name)


def fix_draws(q, Fixed, S, seed=0):
    """Give each posterior factor a ``Fixed`` generator over its own
    buffer of standard normals, enough for one draw of S."""
    for i, v in enumerate(latents(q)):
        n = S * int(np.prod(v.factor.inputs[0][1].shape))
        v.factor._rand_gen = Fixed(
            np.random.default_rng([seed, i]).standard_normal(n))


def jax_svi_draws(key, steps, shape):
    """The standard normals that the JAX batch loop's SVI draws from
    ``key`` for a posterior of one latent: per step, the loop splits its
    key (batch_loop.py), the executor's context splits the step's key
    (inference_alg.py ``next_key``) and the posterior's ancestral
    sampler splits that once for the factor (factor_graph.py
    ``draw_samples``)."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        _, sub = jax.random.split(sub)
        _, sub = jax.random.split(sub)
        out.append(np.asarray(jax.random.normal(sub, shape,
                                                dtype=jnp.float64)))
    return np.concatenate([o.ravel() for o in out])


def pair(build, S, key=0, Alg=(JSVI, StochasticVariationalInference),
         fixed=False, key_steps=None, **alg_kw):
    """The JAX and the port inference of ``build``'s model under a
    mean-field posterior, the port's state carried from the JAX
    initialization at PRNGKey(key). With ``fixed``, both posteriors
    draw from the same fixed buffers; with ``key_steps``, the port's
    posterior (of one latent) draws what the JAX loop draws from
    PRNGKey(key) in that many steps."""
    with jax_f64():
        jm, jobs, data = build(J)
        jq = jmeanfield(model=jm, observed=jobs)
        jinf = JInference(Alg[0](num_samples=S, model=jm, posterior=jq,
                                 observed=jobs, **alg_kw), dtype="float64")
        jinf.initialize(key=jax.random.PRNGKey(key), **data)
    tm, tobs, _ = build(T)
    tq = create_Gaussian_meanfield(model=tm, observed=tobs)
    tinf = GradBasedInference(Alg[1](num_samples=S, model=tm, posterior=tq,
                                     observed=tobs, **alg_kw),
                              dtype="float64", device="cpu")
    tinf.initialize(**data)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    if fixed:
        fix_draws(jq, JFixed, S)
        fix_draws(tq, FixedRandomGenerator, S)
    if key_steps is not None:
        (v,) = latents(tq)
        v.factor._rand_gen = FixedRandomGenerator(jax_svi_draws(
            jax.random.PRNGKey(key), key_steps,
            (S,) + tuple(v.factor.inputs[0][1].shape)))
    return data, jinf, tinf


def by_path(inf):
    paths = name_paths(inf.graphs)
    return {paths[k]: np.asarray(v.detach() if torch.is_tensor(v) else v)
            for k, v in inf.params.param_dict.items()}


def first_loss(jinf, tinf, data):
    """The negative ELBO of both executors on one draw of the fixed
    buffers."""
    jex = jinf.inference_algorithm
    from mxfusion_tpu.inference import create_executor as jcreate
    jl = jcreate(jex, jinf.params)(
        jinf.params.trainable_params(), jinf.params.fixed_params(),
        [data[v.name] for v in jex.observed_variables],
        jax.random.PRNGKey(0))[0]
    talg = tinf.inference_algorithm
    tl = create_executor(talg, tinf.params)(
        tinf.params.trainable_params(), tinf.params.fixed_params(),
        [data[v.name] for v in talg.observed_variables],
        torch.Generator())[0]
    return float(tl.detach()), float(jl)


# ---------------------------------------------------------------------
# the carryover of mean-field posteriors
# ---------------------------------------------------------------------

@pytest.mark.parametrize("with_tau", [False, True])
def test_meanfield_state_carries_over_from_jax(with_tau):
    """Unnamed posterior parameters and unnamed prior constants get
    distinct name paths in either package; the carried state gives the
    JAX package's negative ELBO, float64."""
    data, jinf, tinf = pair(
        lambda P: normal_with_gamma_variance(P, with_tau=with_tau), S=5,
        key=3, fixed=True)
    jpaths, tpaths = name_paths(jinf.graphs), name_paths(tinf.graphs)
    assert sorted(jpaths.values()) == sorted(tpaths.values())
    trained = {jpaths[k] for k in jinf.params.param_dict}
    want = {"mu.mean", "mu.variance"} | (
        {"tau.mean", "tau.variance"} if with_tau else {"s"})
    assert trained == want
    assert {"p(mu).mean", "p(mu).variance", "p(y).mean",
            "p(y).variance"} <= set(tpaths.values())
    tl, jl = first_loss(jinf, tinf, data)
    np.testing.assert_allclose(tl, jl, rtol=1e-12)


def test_existing_name_paths_are_kept():
    """A module input, a module's internal variables and named variables
    keep their paths; a function's unnamed input is qualified by its
    output."""
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.modules import SVGPRegression
    m = mt.Model()
    m.X = mt.Variable(shape=(10, 2))
    m.noise_var = mt.Variable(transformation=PositiveTransformation())
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=2), noise_var=m.noise_var,
        shape=(10, 1), inducing_inputs=mt.Variable(shape=(4, 2)))
    paths = set(name_paths([m]).values())
    assert {"X", "noise_var", "inducing_inputs", "Y.rbf_lengthscale",
            "Y.rbf_variance", "Y.qU_mean", "Y.qU_cov_W",
            "Y.qU_cov_diag"} <= paths
    pm, _, _ = ppca(T)
    assert {"w", "z", "x_mean", "noise", "x", "p(z).mean", "p(z).variance",
            "p(z).mean.data", "p(z).variance.data",
            "p(x).variance"} == set(name_paths([pm]).values())


# ---------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------

@pytest.mark.parametrize("build,family,shape", [
    (ppca, "Normal", (60, 2)), (gamma_exponential, "LogNormal", (1,)),
    (beta_bernoulli, "LogitNormal", (1,)),
    (dirichlet_categorical, "StickBreakingNormal", (3,))])
def test_meanfield_family_follows_support(build, family, shape):
    for P in (J, T):
        m, obs, _ = build(P)
        (v,) = latents(P.meanfield(model=m, observed=obs))
        assert type(v.factor).__name__ == family
        assert tuple(v.factor.inputs[0][1].shape) == shape
        assert tuple(v.factor.inputs[1][1].shape) == shape


def test_meanfield_over_a_symbolic_simplex_raises():
    m = mt.Model()
    m.K = mt.Variable()
    m.p = tdist.Dirichlet.define_variable(alpha=np.ones(3), shape=(m.K,))
    with pytest.raises(InferenceError, match="simplex"):
        create_Gaussian_meanfield(model=m, observed=[])


# ---------------------------------------------------------------------
# SVI trajectories
# ---------------------------------------------------------------------

@pytest.mark.parametrize("build", [ppca, linreg, gamma_exponential,
                                   beta_bernoulli, dirichlet_categorical])
def test_svi_trajectory_and_final_state_match_jax(build):
    """10 Adam steps from the same state on the same draws: the losses
    and every final parameter, rtol 1e-8."""
    steps, S, key = 10, 4, 7
    data, jinf, tinf = pair(build, S=S, key=key, key_steps=steps)
    jl, tl = [], []
    with jax_f64():
        jinf.run(max_iter=steps, learning_rate=0.05,
                 key=jax.random.PRNGKey(key),
                 callback=lambda i, l: jl.append(float(l)), **data)
    tinf.run(max_iter=steps, learning_rate=0.05,
             callback=lambda i, l: tl.append(float(l)), **data)
    np.testing.assert_allclose(tl, jl, rtol=1e-8)
    jstate, tstate = by_path(jinf), by_path(tinf)
    assert jstate.keys() == tstate.keys()
    for k in jstate:
        np.testing.assert_allclose(tstate[k], jstate[k], rtol=1e-8,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("name,build,key", [
    ("ppca_svi", ppca, 11), ("meanfield_linreg", linreg, 12)])
def test_golden_reproduced(name, build, key):
    """tests/goldens/configs.py's configs 1 and 2 through the port, from
    the JAX package's initial state for their key and on the draws of
    that key's schedule: 50 Adam steps, rtol 1e-5, the golden's own."""
    golden = np.load(GOLDENS.format(name))["losses"]
    data, _, tinf = pair(build, S=10, key=key, key_steps=len(golden))
    losses = []
    tinf.run(max_iter=len(golden), learning_rate=0.05,
             callback=lambda i, l: losses.append(float(l)), **data)
    np.testing.assert_allclose(losses, golden, rtol=1e-5)
