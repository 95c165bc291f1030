"""The count SVGPs against the JAX package: ``SVGPPoissonRegression``
with the log link (closed form) and the softplus link (quadrature, with
nodes past f = 20, where ``torch.nn.functional.softplus`` would return f
itself), and ``SVGPNegBinomialRegression`` with a learned scalar and a
per-point dispersion; the bounds and their gradients, the predictions,
forward draws and a carried JAX state. float64, rtol 1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxfusion_tpu.components.distributions.negative_binomial import \
    nb_log_pmf as jnb_log_pmf
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.distributions.negative_binomial import \
    nb_log_pmf
from mxfusion_tpu_torch.ops.elementwise import softplus
from mxfusion_tpu_torch.modules.gp_modules.svgp_negbinom import \
    _dispersion_vs_points

from tests.test_torch_svgp_classification import (
    J, T, RTOL, assert_same_bound, build, by_path, jax_f64, pair, serve)
from mxfusion_tpu_torch.util.carryover import carryover_params, load_state


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


POISSON = "SVGPPoissonRegression"
NB = "SVGPNegBinomialRegression"


def counts(seed, N, M, D=2, scale=1.0):
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 4
    f = np.sin(2.0 * X[:, :1]) * scale + 0.5
    Y = rng.poisson(np.exp(f)).astype(np.float64)
    Z0 = rng.random((M, D)) * 4
    return X, Y, Z0


# ---------------------------------------------------------------------
# Poisson
# ---------------------------------------------------------------------

@pytest.mark.parametrize("whitened", [False, True],
                         ids=["standard", "whitened"])
@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("link", ["log", "softplus"])
def test_poisson_bound_and_gradients_match_jax(link, width, whitened):
    M = 8
    N = 20 if width == "narrow" else 64
    X, Y, Z0 = counts(1, N, M)
    jinf, tinf = pair(POISSON, X, Y, Z0, link=link, whitened=whitened,
                      jitter=1e-4)
    assert_same_bound(jinf, tinf, [X, Y], 6)


def test_softplus_link_past_its_threshold():
    """A mean of 5 and a kernel variance of 12 put the 20-point grid's
    nodes up to f ≈ 30: the softplus operator is logaddexp(f, 0), as
    jax.nn.softplus, and the bound agrees with JAX's there."""
    f = np.array([15.0, 20.5, 25.0, 30.0, -40.0])
    np.testing.assert_allclose(softplus(torch.tensor(f)).numpy(),
                               np.asarray(jax.nn.softplus(f)), rtol=1e-15)
    X, Y, Z0 = counts(2, 24, 6, scale=3.0)
    Y = Y + np.random.default_rng(3).poisson(100.0, Y.shape)
    jinf, tinf = pair(POISSON, X, Y, Z0, link="softplus", variance=12.0,
                      mean=np.full((24, 1), 5.0))
    alg = tinf.inference_algorithm
    ex = T.inf.create_executor(alg, tinf.params)
    env = ex.build_env(tinf.params.trainable_params(),
                       tinf.params.fixed_params(), [X, Y])
    from mxfusion_tpu_torch.modules.gp_modules.svgp_classification import \
        _q_f_moments
    module = tinf.graphs[0].Y.factor
    mu_f, var_f, _, _ = _q_f_moments(env, module._module_graph,
                                     module._extra_graphs[0], 1e-5, False)
    top = float((mu_f + 5.387 * torch.sqrt(2.0 * var_f)).max())
    assert top > 20.0, top
    assert_same_bound(jinf, tinf, [X, Y], 6)


@pytest.mark.parametrize("link", ["log", "softplus"])
def test_poisson_predictions_match_jax(link):
    X, Y, Z0 = counts(4, 40, 7)
    Xt = np.random.default_rng(5).random((150, 2)) * 4
    jinf, tinf = pair(POISSON, X, Y, Z0, link=link)
    jout, tout = serve(jinf, tinf, Xt)
    for j, t in zip(jout, tout):
        assert t.shape == (1, 150, 1)
        np.testing.assert_allclose(t, j, rtol=RTOL)


# ---------------------------------------------------------------------
# negative binomial
# ---------------------------------------------------------------------

def test_nb_log_pmf_matches_jax_without_overflow():
    """``nb_log_pmf`` and its gradient at log means up to 120 (exp
    overflows float32 past 88): float64 against JAX, and float32 finite."""
    rng = np.random.default_rng(6)
    y = rng.poisson(4.0, 40).astype(np.float64)
    log_mu = np.linspace(-30.0, 120.0, 40)
    alpha = rng.uniform(0.1, 3.0, 40)
    jv, jg = jax.value_and_grad(
        lambda lm, a: jnp.sum(jnb_log_pmf(y, lm, a)), argnums=(0, 1))(
            log_mu, alpha)
    lm, a = (torch.tensor(v, requires_grad=True) for v in (log_mu, alpha))
    tv = torch.sum(nb_log_pmf(torch.tensor(y), lm, a))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    for got, want in ((lm.grad, jg[0]), (a.grad, jg[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    v32 = nb_log_pmf(torch.tensor(y, dtype=torch.float32),
                     torch.tensor(log_mu, dtype=torch.float32),
                     torch.tensor(alpha, dtype=torch.float32))
    assert bool(torch.isfinite(v32).all())


@pytest.mark.parametrize("whitened", [False, True],
                         ids=["standard", "whitened"])
@pytest.mark.parametrize("dispersion", ["scalar", "per_point"])
def test_nb_bound_and_gradients_match_jax(dispersion, whitened):
    """The learned scalar dispersion (a seventh gradient) and a per-point
    dispersion of shape (N, 1); wide unwhitened, narrow whitened."""
    M = 8
    N = 64 if not whitened else 20
    X, Y, Z0 = counts(7, N, M)
    kw = dict(whitened=whitened, jitter=1e-4)
    if dispersion == "per_point":
        kw["dispersion"] = np.random.default_rng(8).uniform(0.2, 2.0,
                                                            (N, 1))
    jinf, tinf = pair(NB, X, Y, Z0, **kw)
    assert_same_bound(jinf, tinf, [X, Y], 7 if dispersion == "scalar"
                      else 6)


def test_dispersion_shapes():
    """Scalar (s, 1) -> (s, 1, 1); per point (s, N) and (s, N, 1) ->
    (s, N, 1); anything else raises, as in JAX."""
    for shape, want in (((2, 1), (2, 1, 1)), ((2, 5), (2, 5, 1)),
                        ((2, 5, 1), (2, 5, 1))):
        assert tuple(_dispersion_vs_points(torch.ones(shape)).shape) == want
    with pytest.raises(ValueError, match="one value per data row"):
        _dispersion_vs_points(torch.ones((2, 5, 3)))


@pytest.mark.parametrize("dispersion", ["scalar", "per_point"])
def test_nb_predictions_match_jax(dispersion):
    """A per-point dispersion is a constant of the data's length, so the
    request is one chunk of as many rows as the training data."""
    X, Y, Z0 = counts(9, 64, 7)
    Xt = np.random.default_rng(10).random((64, 2)) * 4
    kw = {}
    if dispersion == "per_point":
        kw["dispersion"] = np.random.default_rng(11).uniform(0.2, 2.0,
                                                             (64, 1))
    jinf, tinf = pair(NB, X, Y, Z0, **kw)
    jout, tout = serve(jinf, tinf, Xt)
    for j, t in zip(jout, tout):
        assert t.shape == (1, 64, 1)
        np.testing.assert_allclose(t, j, rtol=RTOL)


# ---------------------------------------------------------------------
# draws and carryover
# ---------------------------------------------------------------------

@pytest.mark.parametrize("module,link", [(POISSON, "log"),
                                         (POISSON, "softplus"),
                                         (NB, None)])
def test_forward_draws_match_jax(module, link):
    """U → F → rate → counts by forward sampling under the same fixed
    draws (the count draws take their numbers from the buffer)."""
    rng = np.random.default_rng(12)
    n, M, draws = 9, 5, 3
    X = rng.random((n, 2)) * 4
    Z0 = rng.random((M, 2)) * 4
    noise = rng.standard_normal(draws * (M + 3 * n))
    kw = {} if link is None else {"link": link}
    with jax_f64():
        jm = build(J, module, Z0, noise=noise, **kw)
        jinf = J.inf.Inference(J.inf.ForwardSamplingAlgorithm(
            model=jm, observed=[jm.X], num_samples=draws,
            target_variables=[jm.Y.uuid]), dtype="float64")
        jinf.initialize(X=X, key=jax.random.PRNGKey(0))
        (jy,) = jinf.run(X=X, key=jax.random.PRNGKey(0))
    tm = build(T, module, Z0, noise=noise, **kw)
    tinf = T.inf.Inference(T.inf.ForwardSamplingAlgorithm(
        model=tm, observed=[tm.X], num_samples=draws,
        target_variables=[tm.Y.uuid]), dtype="float64", device="cpu")
    tinf.initialize(X=X)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    (ty,) = tinf.run(X=X, generator=torch.Generator().manual_seed(0))
    assert ty.shape == (draws, n, 1)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("module", [POISSON, NB])
def test_carried_state_gives_the_same_bound(module):
    """A JAX state trained by 10 MAP steps, carried by name path into a
    fresh port model: every parameter path, the negative binomial's
    ``dispersion`` among them, and the same bound."""
    X, Y, Z0 = counts(13, 30, 6)
    with jax_f64():
        jm = build(J, module, Z0)
        jinf = J.inf.GradBasedInference(
            J.inf.MAP(model=jm, observed=[jm.X, jm.Y]), dtype="float64")
        jinf.run(X=X, Y=Y, max_iter=10, learning_rate=0.05,
                 key=jax.random.PRNGKey(2))
    state = by_path(jinf.graphs, jinf.params.param_dict)
    want = {"inducing_inputs", "Y.qU_mean", "Y.qU_cov_W", "Y.qU_cov_diag",
            "Y.rbf_lengthscale", "Y.rbf_variance"}
    assert set(state) == (want | {"dispersion"} if module == NB else want)
    tm = build(T, module, Z0)
    params = carryover_params(state, [tm], dtype="float64", device="cpu")
    tinf = T.inf.GradBasedInference(
        T.inf.MAP(model=tm, observed=[tm.X, tm.Y]), dtype="float64",
        device="cpu")
    tinf.initialize(X=X, Y=Y)
    assert set(params.param_dict) == set(tinf.params.param_dict)
    tinf.params.update_params(params.param_dict)
    assert_same_bound(jinf, tinf, [X, Y], len(state))
