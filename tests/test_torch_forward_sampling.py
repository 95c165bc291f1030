"""The MVN slice as a whole against the JAX package: structured PPCA
(a full-covariance Gaussian posterior over each latent z_n) trained by
reparameterized SVI, then forward sampling of the trained posterior and
of the prior; and ``SVGPRegression.draw_samples``.

Both packages start from the same state (the JAX package initializes
it, ``util.carryover.load_state`` moves it into the port's store by
name path) and draw the same noise: every distribution is given a
``FixedRandomGenerator`` over one numpy buffer, reset before each phase,
and the JAX loop runs eagerly (``debug=True``) so that both consume the
buffer draw by draw. float64 throughout."""
import contextlib
import importlib

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
from mxfusion_tpu.components.functions import Function as JFunction
from mxfusion_tpu.components.functions import operators as jops
from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive
from mxfusion_tpu.inference import (
    BatchInferenceLoop as JBatchLoop, ForwardSampling as JForwardSampling,
    GradBasedInference as JInference,
    StochasticVariationalInference as JSVI,
    VariationalPosteriorForwardSampling as JVPFS,
    create_executor as jcreate_executor)
from mxfusion_tpu.models import Posterior as JPosterior

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components import distributions as tdist
from mxfusion_tpu_torch.components.distributions.random_gen import \
    FixedRandomGenerator
from mxfusion_tpu_torch.components.functions import Function
from mxfusion_tpu_torch.components.functions import operators as tops
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    ForwardSampling, GradBasedInference, StochasticVariationalInference,
    VariationalPosteriorForwardSampling, create_executor)
from mxfusion_tpu_torch.models import Posterior
from mxfusion_tpu_torch.util.carryover import load_state, name_paths

# the module (ops.batched_cholesky is the function, as in JAX)
batched_cholesky = importlib.import_module(
    "mxfusion_tpu_torch.ops.batched_cholesky")


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port runs on the card unless the CPU is asked for: these tests
    ask for it, and put the previous default back afterwards."""
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


N, Q, D, S = 16, 8, 12, 4   # points, latent dims, observed dims, samples
FS = 16                      # forward-sampling draws
JITTER = 1e-3


@contextlib.contextmanager
def jax_f64():
    old = jconfig.get_default_dtype()
    jconfig.set_default_dtype("float64")
    try:
        yield
    finally:
        jconfig.set_default_dtype(old)


def ppca_data(seed=0):
    """z, x from a true PPCA, and the noise buffers of the two latent
    factors (q's and the prior's z) and of x."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((Q, D))
    z = rng.standard_normal((N, Q))
    x = z @ W + 0.3 * rng.standard_normal((N, D))
    noise = {name: rng.standard_normal(FS * N * width)
             for name, width in (("q", Q), ("prior", Q), ("x", D))}
    return x, W, noise


def torch_cov(A):
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.matmul(A, A.transpose(-1, -2)) + JITTER * eye


def jax_cov(A):
    return jnp.matmul(A, jnp.swapaxes(A, -1, -2)) + JITTER * jnp.eye(
        A.shape[-1])


def build_ppca(pkg, dist, ops, Func, Post, Positive, cov_fn, gens,
               dtype="float64", n=N):
    """Structured PPCA in either package: z_n ~ N(0, I) written with a
    full precision matrix, x = z·W + noise; q(z_n) = N(q_mu_n,
    q_A_n q_A_nᵀ + 1e-3·I). Every variable is named, so parameters
    cross between the packages by name path."""
    m = pkg.Model()
    m.zero = pkg.Variable(value=0.)
    m.eye = pkg.Variable(value=np.eye(Q))
    m.W = pkg.Variable(shape=(Q, D))
    m.z_mean = ops.broadcast_to(m.zero, (n, Q))
    m.z_precision = ops.broadcast_to(m.eye, (n, Q, Q))
    m.z = dist.MultivariateNormalMeanPrecision.define_variable(
        mean=m.z_mean, precision=m.z_precision, shape=(n, Q),
        rand_gen=gens["prior"], dtype=dtype)
    m.noise = pkg.Variable(transformation=Positive(), initial_value=0.5)
    m.x_mean = ops.dot(m.z, m.W)
    m.x_variance = ops.broadcast_to(m.noise, (n, D))
    m.x = dist.Normal.define_variable(mean=m.x_mean, variance=m.x_variance,
                                      shape=(n, D), rand_gen=gens["x"],
                                      dtype=dtype)
    q = Post(m)
    q.q_mu = pkg.Variable(shape=(n, Q))
    q.q_A = pkg.Variable(shape=(n, Q, Q),
                         initial_value=np.tile(0.5 * np.eye(Q), (n, 1, 1)))
    q.q_cov = Func(cov_fn, input_names=["A"], output_names=["cov"],
                   broadcastable=True)(q.q_A)
    q.z.set_prior(dist.MultivariateNormal(mean=q.q_mu, covariance=q.q_cov,
                                          rand_gen=gens["q"], dtype=dtype))
    return m, q


def _gens(Fixed, noise):
    return {k: Fixed(v) for k, v in noise.items()}


def _reset(*gen_sets):
    for gens in gen_sets:
        for g in gens.values():
            g.reset()


def ppca_pair(seed=0):
    """The JAX inference (initialized from a key) and the port's, loaded
    with the JAX state; each with its generators."""
    x, _, noise = ppca_data(seed)
    jg, tg = _gens(JFixed, noise), _gens(FixedRandomGenerator, noise)
    with jax_f64():
        jm, jq = build_ppca(mj, jdist, jops, JFunction, JPosterior,
                            JPositive, jax_cov, jg)
        jinf = JInference(JSVI(num_samples=S, model=jm, posterior=jq,
                               observed=[jm.x]),
                          grad_loop=JBatchLoop(debug=True), dtype="float64")
        jinf.initialize(x=x, key=jax.random.PRNGKey(seed))
        # a non-trivial start: W away from 0, q's means spread out
        rng = np.random.default_rng(seed + 1)
        jinf.params.param_dict[jm.W.uuid] = jnp.asarray(
            rng.standard_normal((Q, D)) * 0.3)
        jinf.params.param_dict[jq.q_mu.uuid] = jnp.asarray(
            rng.standard_normal((N, Q)) * 0.3)
    tm, tq = build_ppca(mt, tdist, tops, Function, Posterior,
                        PositiveTransformation, torch_cov, tg)
    tinf = GradBasedInference(StochasticVariationalInference(
        num_samples=S, model=tm, posterior=tq, observed=[tm.x]),
        dtype="float64", device="cpu")
    tinf.initialize(x=x)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    return x, (jinf, jg), (tinf, tg)


def _by_path(inf):
    paths = name_paths(inf.graphs)
    return {paths[k]: np.asarray(v.detach() if torch.is_tensor(v) else v)
            for k, v in inf.params.param_dict.items()}


# ---------------------------------------------------------------------
# the slice: SVI on structured PPCA
# ---------------------------------------------------------------------

def test_ppca_elbo_and_gradients_match_jax():
    """The first negative ELBO and its gradient in every trainable
    parameter (W, noise, q_mu, q_A), rtol 1e-8: float64, the same
    state and the same draws."""
    x, (jinf, jg), (tinf, tg) = ppca_pair()
    jex = jcreate_executor(jinf.inference_algorithm, jinf.params)
    jfixed = dict(jinf.params.fixed_params())
    _reset(jg)
    jl, jgrad = jax.value_and_grad(
        lambda tr: jex(tr, jfixed, [x], jax.random.PRNGKey(0))[1])(
        dict(jinf.params.trainable_params()))
    ex = create_executor(tinf.inference_algorithm, tinf.params)
    train = {k: v.clone().requires_grad_(True)
             for k, v in tinf.params.trainable_params().items()}
    _reset(tg)
    loss = ex(train, tinf.params.fixed_params(), [x],
              torch.Generator().manual_seed(0))[1]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-8)
    jpaths = name_paths(jinf.graphs)
    tuuid = {p: u for u, p in name_paths(tinf.graphs).items()}
    assert sorted(jpaths[k] for k in jgrad) == \
        ["W", "noise", "q_A", "q_mu"]
    for k, g in jgrad.items():
        np.testing.assert_allclose(train[tuuid[jpaths[k]]].grad.numpy(),
                                   np.asarray(g), rtol=1e-8, atol=1e-10,
                                   err_msg=jpaths[k])


def test_ppca_svi_trajectory_and_forward_sampling_match_jax():
    """10 Adam steps (lr 0.05): per-step losses and final parameters
    rtol 1e-6; the loss falls. Then 16 draws of z and x from the model
    with the trained posterior grafted in
    (``VariationalPosteriorForwardSampling``), and 16 from the prior
    (``ForwardSampling``), rtol 1e-6 under the same noise."""
    x, (jinf, jg), (tinf, tg) = ppca_pair()
    jm, tm = jinf.graphs[0], tinf.graphs[0]
    _reset(jg, tg)
    jl, tl = [], []
    with jax_f64():
        jinf.run(max_iter=10, learning_rate=0.05, x=x,
                 key=jax.random.PRNGKey(0),
                 callback=lambda i, l: jl.append(float(l)))
    tinf.run(max_iter=10, learning_rate=0.05, x=x,
             callback=lambda i, l: tl.append(float(l)))
    assert len(tl) == len(jl) == 10
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    jp, tp = _by_path(jinf), _by_path(tinf)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)

    _reset(jg, tg)
    with jax_f64():
        jpost = JVPFS(num_samples=FS, observed=[], inherited_inference=jinf,
                      target_variables=[jm.z, jm.x])
        jz, jx = jpost.run(key=jax.random.PRNGKey(1))
    tpost = VariationalPosteriorForwardSampling(
        num_samples=FS, observed=[], inherited_inference=tinf,
        target_variables=[tm.z, tm.x])
    tz, tx = tpost.run(generator=torch.Generator().manual_seed(1))
    assert tz.shape == (FS, N, Q) and tx.shape == (FS, N, D)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-9)

    _reset(jg, tg)
    with jax_f64():
        jprior = JForwardSampling(num_samples=FS, model=jm, observed=[],
                                  infr_params=jinf.params,
                                  target_variables=[jm.z, jm.x])
        jz, jx = jprior.run(key=jax.random.PRNGKey(2))
    tprior = ForwardSampling(num_samples=FS, model=tm, observed=[],
                             infr_params=tinf.params,
                             target_variables=[tm.z, tm.x])
    tz, tx = tprior.run(generator=torch.Generator().manual_seed(2))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-9)
    # the prior is N(0, I): z's draws are the noise itself
    np.testing.assert_allclose(tz.numpy().ravel(),
                               ppca_data()[2]["prior"], rtol=1e-12)


def test_forward_sampling_carries_the_trained_parameters():
    """``ForwardSampling`` starts from the store it is given (the JAX
    test's check, ``test_inference_algorithms.py:140-147``) and returns
    the targets in order."""
    x, _, (tinf, _) = ppca_pair(seed=3)
    tm = tinf.graphs[0]
    tinf.run(max_iter=2, learning_rate=0.05, x=x)
    fwd = ForwardSampling(num_samples=5, model=tm, observed=[],
                          infr_params=tinf.params, target_variables=[tm.x])
    (samples,) = fwd.run(generator=torch.Generator().manual_seed(0))
    assert samples.shape == (5, N, D)
    for v in (tm.W, tm.noise):
        assert torch.equal(fwd.params[v], tinf.params[v])


def test_merged_model_samples_z_from_the_posterior():
    """``merge_posterior_into_model`` swaps z's prior (precision form)
    for q's full-covariance factor, keeping z's UUID; the original model
    keeps its prior."""
    from mxfusion_tpu_torch.inference import merge_posterior_into_model
    _, _, (tinf, _) = ppca_pair(seed=4)
    tm, tq = tinf.graphs
    merged = merge_posterior_into_model(tm, tq, observed=[tm.x])
    assert isinstance(merged[tm.z.uuid].factor, tdist.MultivariateNormal)
    assert isinstance(tm.z.factor, tdist.MultivariateNormalMeanPrecision)
    assert merged[tm.x.uuid].factor is not tm.x.factor


# ---------------------------------------------------------------------
# SVGPRegression.draw_samples
# ---------------------------------------------------------------------

def test_svgp_draw_samples_matches_jax():
    """The module draws U ~ GP(Z), F | U and Y | F by forward sampling
    of its graph (``svgp_sampling``); 8 draws under the same noise and
    the same hyperparameters, rtol 1e-9."""
    from mxfusion_tpu.components.distributions.gp.kernels import RBF as JRBF
    from mxfusion_tpu.inference import (ForwardSamplingAlgorithm as JFSA,
                                        Inference as JPlain)
    from mxfusion_tpu.modules import SVGPRegression as JSVGP
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.inference import (ForwardSamplingAlgorithm,
                                              Inference)
    from mxfusion_tpu_torch.modules import SVGPRegression
    rng = np.random.default_rng(5)
    n, M, Din, draws = 11, 6, 2, 8
    X = rng.random((n, Din)) * 4
    Z0 = rng.random((M, Din)) * 4
    noise = rng.standard_normal(draws * (M + 2 * n))

    def build(pkg, Positive, Rbf, Svgp, Fixed):
        m = pkg.Model()
        m.n = pkg.Variable()
        m.X = pkg.Variable(shape=(m.n, Din))
        m.noise_var = pkg.Variable(transformation=Positive(),
                                   initial_value=0.05)
        m.Y = Svgp.define_variable(
            X=m.X, kernel=Rbf(input_dim=Din, variance=1.3, lengthscale=0.7,
                              dtype="float64"),
            noise_var=m.noise_var, shape=(m.n, 1), rand_gen=Fixed(noise),
            inducing_inputs=pkg.Variable(shape=Z0.shape, initial_value=Z0),
            dtype="float64")
        return m

    with jax_f64():
        jm = build(mj, JPositive, JRBF, JSVGP, JFixed)
        jinf = JPlain(JFSA(model=jm, observed=[jm.X], num_samples=draws,
                           target_variables=[jm.Y.uuid]), dtype="float64")
        jinf.initialize(X=X, key=jax.random.PRNGKey(0))
        (jy,) = jinf.run(X=X, key=jax.random.PRNGKey(0))
    tm = build(mt, PositiveTransformation, RBF, SVGPRegression,
               FixedRandomGenerator)
    tinf = Inference(ForwardSamplingAlgorithm(
        model=tm, observed=[tm.X], num_samples=draws,
        target_variables=[tm.Y.uuid]), dtype="float64", device="cpu")
    tinf.initialize(X=X)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    (ty,) = tinf.run(X=X, generator=torch.Generator().manual_seed(0))
    assert ty.shape == (draws, n, 1)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-9,
                               atol=1e-10)


def test_ppca_step_factors_three_stacks(monkeypatch):
    """Each SVI step factors three stacks, the ones K4 takes on the card:
    q's draw (1·N matrices), the prior's log-pdf on its broadcast
    precision and q's log-pdf (S·N each: the sample axis is broadcast
    and the broadcast view is copied dense by ``cholesky``'s reshape)."""
    from mxfusion_tpu_torch.components.distributions import normal
    x, _, (tinf, tg) = ppca_pair(seed=6)
    seen = []

    def counting(A):
        seen.append(tuple(A.shape))
        return batched_cholesky.cholesky(A)

    monkeypatch.setattr(normal, "_cholesky", counting)
    tinf.run(max_iter=2, learning_rate=0.05, x=x)
    assert seen == [(1, N, Q, Q), (S, N, Q, Q), (S, N, Q, Q)] * 2
