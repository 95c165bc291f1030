"""WAIC, PSIS-LOO, predictive checks and observation masks against the
JAX package.

The port's ``waic``, ``loo_psis``, ``_gpd_fit`` and ``_gpd_quantiles``
(torch, float64, vectorized over data points) give the JAX package's
numpy results at rtol 1e-10 on fixed matrices, every branch included:
the M < 5 plain-IS path, the n < 5 prior, the |ξ| < 1e-12 quantile and a
heavy-tailed column. ``pointwise_log_likelihood`` on fixed (S, C) draws,
on SVGD-shaped particles and after minibatch SGLD (which binds the data
dim to the batch) gives JAX's matrix at 1e-10; the predictive check on
fixed draws gives JAX's statistics. Array ``rv_scaling`` (observation
masks) passes the seven cases of
``tests/inference/test_masked_likelihood.py``, gives JAX's masked
objective at 1e-10, a masked run's zip loads in either package, and
Laplace after a masked fit ignores the mask as JAX's does (a fault kept
from the reference)."""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from mxfusion_tpu import inference as jinference
from mxfusion_tpu.inference import model_comparison as jmc

from mxfusion_tpu_torch import inference as tinference
from mxfusion_tpu_torch.common.exceptions import InferenceError
from mxfusion_tpu_torch.inference import model_comparison as tmc
from mxfusion_tpu_torch.modules import SVGPRegression
from tests.test_torch_hmc_chees import (  # noqa: F401
    J as J_, T as T_, _jax_in_float64, _on_the_cpu_in_float64,
    _one_torch_thread, blr, close, conjugate_gaussian, gp_noise)
from tests.test_torch_sgld_svgd_tempering import gaussian_mean

J = SimpleNamespace(**vars(J_), inf=jinference)
T = SimpleNamespace(**vars(T_), inf=tinference)


def assert_same(port, ref, rtol=1e-10):
    """Dicts of floats and arrays agree key by key (NaN where NaN)."""
    assert sorted(port) == sorted(ref)
    for k in ref:
        close(port[k], ref[k], rtol=rtol)


# ---------------------------------------------------------------------
# WAIC, PSIS-LOO and the generalized-Pareto fit on fixed matrices
# ---------------------------------------------------------------------

def fixed_loglik(case):
    rng = np.random.default_rng(7)
    if case == "tiny":                   # M = 0 < 5: plain IS, k NaN
        return rng.standard_normal((4, 5)) - 1.0
    ll = rng.standard_normal((240, 60)) * 0.4 - 1.2
    ll[:, 5] = rng.standard_t(1.2, 240) * 4.0 - 3.0   # heavy tail
    ll[:, 6] = np.repeat(ll[:40, 6], 6)               # repeated draws
    ll[:, 7] = -1.0                                    # one value
    return ll


@pytest.mark.parametrize("case", ["tiny", "typical"])
def test_waic_and_loo_match_jax(case):
    ll = fixed_loglik(case)
    assert_same(tmc.waic(torch.as_tensor(ll)), jmc.waic(ll))
    ref = jmc.loo_psis(ll)
    out = tmc.loo_psis(torch.as_tensor(ll))
    assert_same(out, ref)
    assert np.isnan(ref["pareto_k"]).all() == (case == "tiny")
    assert np.isfinite(out["elpd_loo"])


def gpd_draws(rng, xi, sigma, n):
    u = rng.random(n)
    return sigma * np.expm1(-xi * np.log1p(-u)) / xi


def test_gpd_fit_and_quantiles_match_jax():
    """Each sample alone and the rows of one batch, against JAX's fit;
    the n < 5 prior; both quantile branches."""
    rng = np.random.default_rng(0)
    rows = [gpd_draws(rng, xi, 1.0, 40) for xi in (0.5, -0.2, 0.9)]
    samples = rows + [gpd_draws(rng, 0.5, 1.0, 4000), rng.random(3)]
    p = (np.arange(1, 41) - 0.5) / 40
    for x in samples:
        xi, sigma = jmc._gpd_fit(x)
        txi, tsigma = tmc._gpd_fit(torch.as_tensor(x))
        close(txi, xi)
        close(tsigma, sigma)
        close(tmc._gpd_quantiles(p, txi, tsigma),
              jmc._gpd_quantiles(p, xi, sigma))
    bxi, bsigma = tmc._gpd_fit(torch.as_tensor(np.stack(rows)))
    for x, a, b in zip(rows, bxi, bsigma):
        close(a, jmc._gpd_fit(x)[0])
        close(b, jmc._gpd_fit(x)[1])
    close(tmc._gpd_quantiles(p, torch.zeros(()), torch.full((), 2.0)),
          jmc._gpd_quantiles(p, 0.0, 2.0))
    assert float(tmc._gpd_fit(torch.as_tensor(samples[3]))[0]) > 0.4


# ---------------------------------------------------------------------
# the pointwise log-likelihood and the predictive check
# ---------------------------------------------------------------------

def sampler_side(P, build, **kw):
    m, obs, data = build(P, **kw)
    inf = P.hmc.HMCInference(P.hmc.HMCAlgorithm(model=m, observed=obs),
                             **({} if P is J else {"device": "cpu"}))
    inf.initialize(**data)
    return m, obs, data, inf


@pytest.mark.parametrize("has_chain_axis", [True, False],
                         ids=["chains", "particles"])
def test_pointwise_loglik_matches_jax(has_chain_axis):
    """A Normal mean at fixed draws: (S, C, 1) chains or (S, 1)
    particles, one batched evaluation in each package."""
    mj, _, data, jinf = sampler_side(J, conjugate_gaussian)
    mt, _, _, tinf = sampler_side(T, conjugate_gaussian)
    shape = (7, 3, 1) if has_chain_axis else (9, 1)
    mu = np.random.default_rng(1).standard_normal(shape) + 3.0
    ref = jmc.pointwise_log_likelihood(
        jinf, samples={mj.mu.uuid: mu}, has_chain_axis=has_chain_axis,
        **data)
    out = tmc.pointwise_log_likelihood(
        tinf, samples={mt.mu.uuid: torch.as_tensor(mu)},
        has_chain_axis=has_chain_axis, **data)
    assert sorted(out) == sorted(ref) == ["y"]
    close(out["y"], ref["y"])
    close(out["y"], stats.norm.logpdf(data["y"][:, 0][None, :],
                                      mu.reshape(-1, 1), 2.0), rtol=1e-12)


def test_pointwise_loglik_skips_a_conditioning_input():
    """BLR observes X, which has no density: the port gives y's matrix
    alone, where the JAX package stops at X (``None.log_pdf``)."""
    mj, _, data, jinf = sampler_side(J, blr)
    mt, _, _, tinf = sampler_side(T, blr)
    w = np.random.default_rng(1).standard_normal((7, 3, 3, 1))
    with pytest.raises(AttributeError, match="log_pdf"):
        jmc.pointwise_log_likelihood(jinf, samples={mj.w.uuid: w}, **data)
    out = tmc.pointwise_log_likelihood(
        tinf, samples={mt.w.uuid: torch.as_tensor(w)}, **data)
    assert list(out) == ["y"]
    close(out["y"], stats.norm.logpdf(
        data["y"][:, 0][None, :], w.reshape(-1, 3) @ data["X"].T, 0.5),
        rtol=1e-12)


def test_pointwise_loglik_and_predictive_check_after_minibatch_sgld():
    """test_model_comparison.py:96-121: minibatch SGLD binds the data dim
    to B; the evaluation re-binds it to N for its executor and restores
    the batch binding after. The predictive check re-binds it too, so its
    replicates have the data's N rows, where the JAX package's have B."""
    n_full, B = 96, 16
    runs = {}
    for P in (J, T):
        m, obs, data = gaussian_mean(P, N=n_full)
        alg = P.inf.SGLDAlgorithm(
            model=m, observed=obs, num_samples=6, num_burnin=4,
            num_chains=2, batch_size=B, step_size=2e-4,
            step_decay_gamma=0.0)
        if P is J:
            inf = P.inf.SGLDInference(alg)
            inf.run(key=jax.random.PRNGKey(4), **data)
        else:
            inf = P.inf.SGLDInference(alg, device="cpu")
            inf.run(generator=torch.Generator().manual_seed(4), **data)
        runs[P is T] = (m, inf, data)
    (mj, jinf, data), (mt, tinf, _) = runs[False], runs[True]
    draws = tinf._samples
    bound = dict(tinf.params.constants)
    out = tmc.pointwise_log_likelihood(tinf, **data)["y"]
    ref = jmc.pointwise_log_likelihood(
        jinf, samples={mj.mu.uuid: draws[mt.mu.uuid].numpy()}, **data)["y"]
    assert tuple(out.shape) == (12, n_full)
    close(out, ref)
    assert tinf.params.constants == bound
    expected = stats.norm.logpdf(data["y"][:, 0][None, :],
                                 draws[mt.mu.uuid].numpy().reshape(-1, 1),
                                 1.0)
    close(out, expected, rtol=1e-12)
    rows = {}
    for P, inf, mc, run in ((J, jinf, jmc, {"key": jax.random.PRNGKey(1)}),
                            (T, tinf, tmc, {})):
        rows[P is T] = mc.posterior_predictive_check(
            inf, lambda r: r.shape[0], "y", **run, **data)["T_rep"]
    assert set(np.asarray(rows[False]).tolist()) == {B}
    assert set(rows[True].tolist()) == {n_full}
    assert tinf.params.constants == bound


def test_pointwise_loglik_refuses_a_module_observation():
    m, _, data, inf = sampler_side(T, gp_noise)
    with pytest.raises(InferenceError, match="explicit likelihood factor"):
        tmc.pointwise_log_likelihood(
            inf, samples={m.noise_var.uuid: torch.full((2, 2, 1), 0.01)},
            **data)


def noisy_mean(P, N=20):
    """A Normal mean under a unit-variance likelihood whose draws come
    from a fixed buffer (the predictive replicates)."""
    m = P.pkg.Model()
    m.mu = P.dist.Normal.define_variable(mean=0., variance=100., shape=(1,))
    m.y = P.dist.Normal.define_variable(
        mean=P.ops.broadcast_to(m.mu, (N, 1)),
        variance=P.ops.broadcast_to(P.pkg.Variable(value=1.0), (N, 1)),
        shape=(N, 1), rand_gen=P.Fixed(
            np.random.default_rng(3).standard_normal(12 * N)))
    y = np.random.default_rng(4).standard_normal((N, 1)) + 1.5
    return m, [m.y], {"y": y}


def test_posterior_predictive_check_matches_jax():
    mj, _, data, jinf = sampler_side(J, noisy_mean)
    mt, _, _, tinf = sampler_side(T, noisy_mean)
    mu = np.random.default_rng(5).standard_normal((6, 2, 1)) * 0.1 + 1.5
    jinf._samples = {mj.mu.uuid: mu}
    tinf._samples = {mt.mu.uuid: torch.as_tensor(mu)}
    ref = jmc.posterior_predictive_check(
        jinf, lambda y: y.var(), "y", key=jax.random.PRNGKey(1), **data)
    out = tmc.posterior_predictive_check(
        tinf, lambda y: y.var(correction=0), "y", **data)
    assert_same(out, ref)
    assert tuple(out["T_rep"].shape) == (12,)
    with pytest.raises(InferenceError, match="checked variable's data"):
        tmc.posterior_predictive_check(tinf, lambda y: y.var(), "y")


# ---------------------------------------------------------------------
# observation masks: tests/inference/test_masked_likelihood.py
# ---------------------------------------------------------------------

N = 100


def masked_model(P):
    m = P.pkg.Model()
    m.mu = P.dist.Normal.define_variable(mean=0., variance=100., shape=(1,))
    m.y = P.dist.Normal.define_variable(
        mean=P.ops.broadcast_to(m.mu, (N, 1)),
        variance=P.ops.broadcast_to(P.pkg.Variable(value=1.0), (N, 1)),
        shape=(N, 1))
    return m


def masked_data(seed=0):
    rng = np.random.default_rng(seed)
    y_full = rng.standard_normal((N, 1)) * 2.0 + 3.0
    mask = (rng.random((N, 1)) < 0.7).astype(np.float64)
    # poison the missing entries: the mask must make them irrelevant
    y_obs = np.where(mask > 0, y_full, 1e6)
    return y_full, mask, y_obs


def map_inference(P, m, **kw):
    extra = {} if P is J else {"device": "cpu"}
    return P.inf.GradBasedInference(P.inf.MAP(model=m, observed=[m.y]),
                                    dtype="float64", **extra, **kw)


def test_masked_map_matches_observed_subset_posterior():
    y_full, mask, y_obs = masked_data()
    m = masked_model(T)
    infr = map_inference(T, m)
    infr.run(y=y_obs, max_iter=500, learning_rate=0.1,
             rv_scaling={m.y: mask})
    loc = infr.inference_algorithm.posterior[m.mu].factor.location
    mu_hat = float(infr.params[loc].reshape(-1)[0])
    expected = y_full[mask > 0].sum() * 100.0 / (100.0 * mask.sum() + 1.0)
    np.testing.assert_allclose(mu_hat, expected, atol=5e-3)


def masked_executor(P, seed):
    _, mask, y_obs = masked_data(seed)
    m = masked_model(P)
    infr = map_inference(P, m)
    if P is J:
        infr.initialize(y=y_obs, key=jax.random.PRNGKey(0))
    else:
        infr.initialize(y=y_obs, generator=torch.Generator().manual_seed(0))
    ex = P.inf.create_executor(infr.inference_algorithm, infr.params,
                               rv_scaling={m.y.uuid: mask})
    return m, infr, ex, mask, y_obs


def port_loss(infr, ex, y, fixed=None):
    return float(ex(infr.params.trainable_params(),
                    infr.params.fixed_params() if fixed is None else fixed,
                    [y], torch.Generator())[0])


def test_masked_objective_value_equals_subset_objective():
    _, infr, ex, mask, y_obs = masked_executor(T, seed=1)
    y_alt = np.where(mask > 0, y_obs, -7.0)
    np.testing.assert_allclose(port_loss(infr, ex, y_obs),
                               port_loss(infr, ex, y_alt), rtol=1e-12)


def test_masked_objective_matches_jax():
    mj, jinf, jex, _, y_obs = masked_executor(J, seed=1)
    mt, tinf, tex, _, _ = masked_executor(T, seed=1)
    loc_j = jinf.inference_algorithm.posterior[mj.mu].factor.location
    loc_t = tinf.inference_algorithm.posterior[mt.mu].factor.location
    tinf.params[loc_t] = np.asarray(jinf.params[loc_j])
    ref = float(jex(jinf.params.trainable_params(),
                    jinf.params.fixed_params(), [y_obs],
                    jax.random.PRNGKey(0))[0])
    close(port_loss(tinf, tex, y_obs), ref)


def test_laplace_after_a_masked_map_ignores_the_mask_as_jax_does():
    """A known fault kept from the JAX package: ``laplace_approximation``
    builds its own executor without the run's mask, so after a masked
    MAP fit the mean is the masked mode but the Hessian, covariance and
    evidence use every row of the data passed in. Both packages give the
    same result at the same point: the covariance of all N points."""
    _, mask, y_obs = masked_data(seed=9)
    jm, tm = masked_model(J), masked_model(T)
    jinf, tinf = map_inference(J, jm), map_inference(T, tm)
    jinf.run(y=y_obs, max_iter=50, learning_rate=0.1,
             rv_scaling={jm.y: mask}, key=jax.random.PRNGKey(0))
    tinf.initialize(y=y_obs)
    loc_j = jinf.inference_algorithm.posterior[jm.mu].factor.location
    loc_t = tinf.inference_algorithm.posterior[tm.mu].factor.location
    tinf.params[loc_t] = np.asarray(jinf.params[loc_j])
    jres = jinference.laplace_approximation(jinf, y=y_obs)
    tres = tinference.laplace_approximation(tinf, y=y_obs)
    close(tres.cov, jres.cov, rtol=1e-10)
    close(tres.log_evidence, jres.log_evidence, rtol=1e-10)
    close(tres.cov[0, 0], 1.0 / (N + 0.01), rtol=1e-10)


def test_masked_svi_posterior_concentrates_on_observed():
    y_full, mask, y_obs = masked_data(seed=2)
    m = masked_model(T)
    q = T.inf.create_Gaussian_meanfield(model=m, observed=[m.y])
    infr = T.inf.GradBasedInference(T.inf.StochasticVariationalInference(
        num_samples=10, model=m, posterior=q, observed=[m.y]),
        dtype="float64", device="cpu")
    infr.run(y=y_obs, max_iter=600, learning_rate=0.1,
             rv_scaling={m.y: mask},
             generator=torch.Generator().manual_seed(0))
    mu_hat = float(infr.params[q.mu.factor.mean].reshape(-1)[0])
    np.testing.assert_allclose(mu_hat, y_full[mask > 0].mean(), atol=0.3)


def test_minibatch_loop_rejects_run_level_rv_scaling():
    _, mask, y_obs = masked_data(seed=3)
    m = masked_model(T)
    infr = map_inference(
        T, m, grad_loop=T.inf.MinibatchInferenceLoop(batch_size=20))
    with pytest.raises(ValueError):
        infr.run(y=y_obs, max_iter=10, rv_scaling={m.y: mask})


def test_rank_mismatched_mask_raises():
    _, mask, y_obs = masked_data(seed=4)
    m = masked_model(T)
    with pytest.raises(InferenceError, match="rank"):
        map_inference(T, m).run(y=y_obs, max_iter=5,
                                rv_scaling={m.y: mask[:, 0]})


def test_module_array_mask_raises():
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    rng = np.random.default_rng(5)
    X = rng.random((30, 1))
    Y = rng.standard_normal((30, 1))
    m = T.pkg.Model()
    m.n = T.pkg.Variable()
    m.X = T.pkg.Variable(shape=(m.n, 1))
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=1), noise_var=T.pkg.Variable(value=0.1),
        shape=(m.n, 1), num_inducing=4)
    infr = T.inf.GradBasedInference(T.inf.MAP(model=m, observed=[m.X, m.Y]),
                                    device="cpu")
    with pytest.raises(InferenceError, match="module"):
        infr.run(X=X, Y=Y, max_iter=5, rv_scaling={m.Y: np.ones((30, 1))})


def test_mask_rides_as_executor_argument():
    """The mask joins each call's fixed parameters under
    ``uuid:rv_scale`` as a tensor on the run's device, and stays out of
    the parameter store; a fixed argument under that key replaces it for
    the call, and swapping it there changes the objective."""
    m, infr, ex, mask, y_obs = masked_executor(T, seed=6)
    key = m.y.uuid + ":rv_scale"
    fixed = infr.params.fixed_params()
    assert key not in fixed and key not in infr.params.param_dict
    env = ex.build_env(infr.params.trainable_params(), fixed, [y_obs])
    assert isinstance(env[key], torch.Tensor)
    close(env[key][0], mask, rtol=0)
    as_given = dict(fixed, **{key: torch.as_tensor(mask)})
    masked_out = dict(fixed, **{key: torch.zeros(N, 1, dtype=torch.float64)})
    assert port_loss(infr, ex, y_obs) == port_loss(infr, ex, y_obs, as_given)
    assert port_loss(infr, ex, y_obs) != port_loss(infr, ex, y_obs,
                                                   masked_out)


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_masked_run_zip_loads_in_the_other_package(saved_by, tmp_path):
    """A masked run's zip crosses packages: the port loads the JAX zip,
    whose mask entry is run data it drops, and writes no mask itself, so
    the JAX package loads the port's zip (its own masked zip it refuses:
    the mask key reconciles with no variable); the loaded MAP location
    is the saved one."""
    _, mask, y_obs = masked_data(seed=8)
    P_from, P_to = (J, T) if saved_by == "jax" else (T, J)
    m = masked_model(P_from)
    src = map_inference(P_from, m)
    run = {"key": jax.random.PRNGKey(0)} if P_from is J else {}
    src.run(y=y_obs, max_iter=20, learning_rate=0.1,
            rv_scaling={m.y: mask}, **run)
    path = str(tmp_path / "masked.zip")
    src.save(path)
    m2 = masked_model(P_to)
    dst = map_inference(P_to, m2)
    dst.initialize(y=y_obs)
    dst.load(path)
    loc = src.inference_algorithm.posterior[m.mu].factor.location
    loc2 = dst.inference_algorithm.posterior[m2.mu].factor.location
    close(dst.params[loc2], np.asarray(src.params[loc]), rtol=1e-12)
    assert not any(k.endswith(":rv_scale") for k in dst.params.param_dict)
    if saved_by == "jax":
        from mxfusion_tpu.common.exceptions import \
            InferenceError as JInferenceError
        again = map_inference(J, masked_model(J))
        again.initialize(y=y_obs)
        with pytest.raises(JInferenceError, match="rv_scale has no "
                           "reconciled match"):
            again.load(path)
