"""SGLD, SVGD and parallel tempering against the JAX package.

Built on the models and the two-package sides of
``tests/test_torch_hmc_chees.py``. The sampling executor's N/B
likelihood rescaling, one (p)SGLD step on fixed minibatch indices and
noise, and one tempered sweep with its swap pass on fixed draws agree
with the same steps written out from the JAX package's lines at rtol
1e-10 in float64; SVGD, deterministic after its initial draw, agrees
with JAX's whole run from the same fixed particles at rtol 1e-8. Whole
chains are the port's alone, held to the conjugate and behavioural
oracles of ``tests/inference/test_{sgld,svgd,tempering}.py`` on shorter
chains."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxfusion_tpu.inference import inference_alg as jalg
from mxfusion_tpu.inference import hmc as jhmc
from mxfusion_tpu.inference.svgd import (SVGDAlgorithm as JSVGDAlgorithm,
                                         SVGDInference as JSVGDInference)

from mxfusion_tpu_torch.common.exceptions import InferenceError
from mxfusion_tpu_torch.inference import hmc as thmc
from mxfusion_tpu_torch.inference import inference_alg as talg
from mxfusion_tpu_torch.inference import sgld as tsgld
from mxfusion_tpu_torch.inference import svgd as tsvgd
from mxfusion_tpu_torch.inference import tempering as ttemp
from mxfusion_tpu_torch.inference import (
    HMCAlgorithm, HMCInference, ParallelTemperingAlgorithm,
    ParallelTemperingInference, SGLDAlgorithm, SGLDInference,
    SVGDAlgorithm, SVGDInference)
from tests.test_torch_hmc_chees import (  # noqa: F401
    J, T, _jax_in_float64, _on_the_cpu_in_float64, _one_torch_thread, blr,
    by_uuid, close, conjugate_gaussian, gamma_exponential, gen, gp_noise,
    model_latents)


def gaussian_mean(P, N=64, s2=1.0, tau2=100.0, seed=0, extra_latent=False):
    """tests/inference/test_sgld.py:19-28: the data axis a symbolic dim,
    which minibatch SGLD binds to the batch size; ``extra_latent`` adds
    test_sgld.py:107-114's near-pinned second latent."""
    y = np.random.default_rng(seed).standard_normal((N, 1)) * \
        np.sqrt(s2) + 2.0
    m = P.pkg.Model()
    m.n = P.pkg.Variable()
    m.mu = P.dist.Normal.define_variable(mean=0., variance=tau2, shape=(1,))
    if extra_latent:
        m.z = P.dist.Normal.define_variable(mean=0., variance=1e-4,
                                            shape=(1,))
    m.y = P.dist.Normal.define_variable(
        mean=P.ops.broadcast_to(m.mu, (m.n, 1)),
        variance=P.ops.broadcast_to(P.pkg.Variable(value=s2), (m.n, 1)),
        shape=(m.n, 1))
    return m, [m.y], {"y": y}


def minibatch_side(P, N, B, C, extra_latent=False):
    """A model with a symbolic data dim bound to B, its executor built
    with the N/B rescaling (SGLDInference.run's set-up), the env over
    all N rows and C chains of fixed prior draws."""
    m, observed, data = gaussian_mean(P, N=N, extra_latent=extra_latent)
    uuids = model_latents(m, observed)
    for i, u in enumerate(uuids):
        m[u].factor._rand_gen = P.Fixed(
            np.random.default_rng([1, i]).standard_normal(C))
    alg = P.hmc.HMCAlgorithm(model=m, observed=observed, num_chains=C)
    inf = P.hmc.HMCInference(alg)
    inf.initialize(y=data["y"][:B])            # binds n to B
    executor = P.alg.create_sampling_executor(
        alg, inf.params, rv_scaling={m.y.uuid: N / B})
    env = executor.build_env(inf.params.trainable_params(),
                             inf.params.fixed_params(), [data["y"]])
    if P is J:
        ctx = jalg.RuntimeContext(jax.random.PRNGKey(0))
        q = jhmc.init_chains_from_prior(m, env, ctx.next_key(), uuids, C)
    else:
        ctx = talg.RuntimeContext(gen())
        q = thmc.init_chains_from_prior(m, env, gen(), uuids, C)
    return m, observed, uuids, env, ctx, q


def jax_log_joint(m, env, ctx, q, dtype=jnp.float64):
    e = jalg.VariableEnv(env)
    e.update(q)
    return jhmc.sum_log_pdf_terms(m.log_pdf_terms(e, ctx=ctx), dtype)


def port_keys(mt_, mj_, d):
    names = {mt_[u].name: u for u in mt_.variables}
    return {names[mj_[u].name]: v for u, v in d.items()}


def test_sampling_executor_applies_rv_scaling_as_jax():
    """The repaired ``create_sampling_executor(..., rv_scaling=)``: the
    minibatch log joint at N/B equals JAX's, and its likelihood term is
    N/B times the unscaled one."""
    N, B, C = 40, 8, 3
    mj_, obs_j, uj, env_j, ctx_j, q_j = minibatch_side(J, N, B, C)
    mt_, obs_t, ut, env_t, ctx_t, q_t = minibatch_side(T, N, B, C)
    idx = np.random.default_rng(2).integers(0, N, B)
    be_j = jalg.VariableEnv(env_j)
    be_j[mj_.y] = jnp.take(env_j[mj_.y], jnp.asarray(idx), axis=1)
    be_t = SGLDAlgorithm._batch_env(env_t, [mt_.y.uuid],
                                   torch.as_tensor(idx), N)
    ref = jax_log_joint(mj_, be_j, ctx_j, q_j)
    out = thmc.sum_log_pdf_terms(mt_.log_pdf_terms(
        talg.VariableEnv({**be_t, **q_t}), ctx=ctx_t), torch.float64)
    close(out, ref)
    # the likelihood term alone carries the N/B scale
    env = talg.VariableEnv({**be_t, **q_t})
    assert mt_.y.factor.log_pdf_scaling == N / B
    (lik,) = mt_.log_pdf_terms(talg.VariableEnv(env), targets=[mt_.y])
    mt_.y.factor.log_pdf_scaling = 1.0
    (lik1,) = mt_.log_pdf_terms(talg.VariableEnv(env), targets=[mt_.y])
    close(lik, N / B * lik1, rtol=1e-12)


@pytest.mark.parametrize("preconditioning", [False, True])
def test_sgld_step_matches_jax(preconditioning):
    """Two (p)SGLD steps on fixed minibatch indices and Langevin noise
    (sgld.py:137-172) with the step schedule at t = 0, 1."""
    N, B, C = 40, 8, 3
    alg_t = SGLDAlgorithm(model=None, observed=[], step_size=2e-3,
                          preconditioning=preconditioning)
    mj_, obs_j, uj, env_j, ctx_j, q_j = minibatch_side(J, N, B, C, True)
    mt_, obs_t, ut, env_t, ctx_t, q_t = minibatch_side(T, N, B, C, True)
    rng = np.random.default_rng(3)
    a, b, gamma, alpha, lam = 2e-3, 1000.0, 0.55, 0.99, 1e-5
    V_j = {u: jnp.zeros_like(v) for u, v in q_j.items()}
    V_t = {u: torch.zeros_like(v) for u, v in q_t.items()}
    for t in range(2):
        idx = rng.integers(0, N, B)
        noise = {u: rng.standard_normal(np.shape(v)) for u, v in q_j.items()}
        be_j = jalg.VariableEnv(env_j)
        be_j[mj_.y] = jnp.take(env_j[mj_.y], jnp.asarray(idx), axis=1)
        g_j = jax.grad(lambda q: jnp.sum(jax_log_joint(mj_, be_j, ctx_j,
                                                       q)))(q_j)
        eps = a * (1.0 + t / b) ** (-gamma)
        qn_j, Vn_j = {}, {}
        for u in q_j:
            if preconditioning:
                Vn_j[u] = alpha * V_j[u] + (1.0 - alpha) * g_j[u] ** 2
                P = 1.0 / (lam + jnp.sqrt(Vn_j[u]))
            else:
                Vn_j[u], P = V_j[u], 1.0
            qn_j[u] = q_j[u] + 0.5 * eps * P * g_j[u] + \
                jnp.sqrt(eps * P) * noise[u]
        be_t = SGLDAlgorithm._batch_env(env_t, [mt_.y.uuid],
                                       torch.as_tensor(idx), N)
        _, g_t = thmc.value_and_grad(
            thmc.log_posterior(mt_, be_t, ctx_t, None, torch.float64), q_t)
        by_uuid(port_keys(mt_, mj_, g_j), g_t)
        eps_t = alg_t._step_size_at(t, q_t[ut[0]])
        close(eps_t, eps)
        q_t, V_t = tsgld._sgld_step(
            q_t, V_t, g_t, port_keys(mt_, mj_, {
                u: torch.as_tensor(v) for u, v in noise.items()}),
            eps_t, preconditioning, alpha, lam)
        q_j, V_j = qn_j, Vn_j
        by_uuid(port_keys(mt_, mj_, q_j), q_t)
        by_uuid(port_keys(mt_, mj_, V_j), V_t)


def jax_swap_pass(q, lp, betas, t_idx, K, parity, u):
    """mxfusion_tpu/inference/tempering.py:165-192 on explicit uniforms."""
    R = lp.shape[0]
    lp_up = jnp.roll(lp, -1)
    beta_up = jnp.roll(betas, -1)
    is_lower = (t_idx % 2 == parity) & (t_idx < K - 1)
    log_alpha = (betas - beta_up) * (lp_up - lp)
    do_swap = is_lower & (jnp.log(u) < log_alpha)
    take_prev = jnp.roll(do_swap, 1)
    qn = {}
    for uu, x in q.items():
        shape = (R,) + (1,) * (x.ndim - 1)
        qn[uu] = jnp.where(do_swap.reshape(shape), jnp.roll(x, -1, axis=0),
                           jnp.where(take_prev.reshape(shape),
                                     jnp.roll(x, 1, axis=0), x))
    lpn = jnp.where(do_swap, lp_up, jnp.where(take_prev, jnp.roll(lp, 1),
                                              lp))
    return qn, lpn, do_swap, is_lower


@pytest.mark.parametrize("parity", [0, 1])
def test_pt_swap_pass_matches_jax(parity):
    C, K = 3, 4
    R = C * K
    rng = np.random.default_rng(4 + parity)
    betas = np.tile(np.geomspace(1.0, 0.05, K), C)
    t_idx = np.tile(np.arange(K), C)
    q = {"x": rng.standard_normal((R, 2))}
    lp = rng.standard_normal(R) * 3.0
    u = rng.uniform(size=R)
    qn_j, lpn_j, sw_j, low_j = jax_swap_pass(
        {"x": jnp.asarray(q["x"])}, jnp.asarray(lp), jnp.asarray(betas),
        jnp.asarray(t_idx), K, parity, jnp.asarray(u))
    qn, lpn, glpn, sw, low = ttemp._swap_pass(
        {"x": torch.as_tensor(q["x"])}, torch.as_tensor(lp),
        {"x": torch.as_tensor(2.0 * q["x"])}, torch.as_tensor(betas),
        torch.as_tensor(t_idx), K, parity, torch.log(torch.as_tensor(u)))
    assert 0 < int(sw.sum()) < int(low.sum())
    assert np.array_equal(sw.numpy(), np.asarray(sw_j))
    assert np.array_equal(low.numpy(), np.asarray(low_j))
    by_uuid(qn, qn_j)
    close(lpn, lpn_j)
    # the carried gradient moves with its state
    close(glpn["x"], 2.0 * np.asarray(qn_j["x"]))


def test_pt_sweep_matches_jax():
    """One tempered sweep and swap pass of ``ParallelTemperingAlgorithm``
    (1 kept draw, no warmup) against tempering.py:90-192 on the same
    draws: per-replica steps ε·β^(-1/2), the tempered Metropolis test
    and the carried log posterior through the swaps."""
    from tests.test_torch_hmc_chees import one_side
    C, K, L, eps = 2, 3, 4, 0.05
    R = C * K
    js = one_side(J, gamma_exponential, R)
    m, obs, data = gamma_exponential(T)
    (u,) = model_latents(m, obs)
    m[u].factor._rand_gen = T.Fixed(np.random.default_rng(
        [0, 0]).uniform(0.2, 2.0, 2 * R))
    infr = ParallelTemperingInference(ParallelTemperingAlgorithm(
        model=m, observed=obs, num_samples=1, num_warmup=0, num_chains=C,
        num_temps=K, step_size=eps, num_leapfrog=L))
    out = infr.run(generator=gen(9), **data)[u]
    # the draws the sweep took, in its order
    g = gen(9)
    p0 = torch.randn((R, 1), generator=g, dtype=torch.float64)
    log_u = torch.log(torch.rand((R,), generator=g, dtype=torch.float64))
    swap_u = torch.rand((R,), generator=g, dtype=torch.float64)
    betas = jnp.tile(jnp.asarray(np.geomspace(1.0, 0.05, K)), C)
    (uj,) = js.uuids

    def log_post(q):
        return -js.neg_logp(q)

    def neg_logp_t(q):
        return -betas * log_post(q)
    er = (jnp.exp(jnp.log(eps)) * betas ** -0.5).reshape(R, 1)
    grad_U = jax.grad(lambda q: jnp.sum(neg_logp_t(q)))
    q = js.z
    p = {uj: jnp.asarray(p0.numpy())}
    H0 = -betas * log_post(q) + 0.5 * p[uj][:, 0] ** 2
    gq = grad_U(q)
    p = {uj: p[uj] - 0.5 * er * gq[uj]}
    q1 = q
    for i in range(L):
        q1 = {uj: q1[uj] + er * p[uj]}
        gq = grad_U(q1)
        p = {uj: p[uj] - (0.5 if i == L - 1 else 1.0) * er * gq[uj]}
    lp1 = log_post(q1)
    dH = H0 - (-betas * lp1 + 0.5 * p[uj][:, 0] ** 2)
    accept = jnp.asarray(log_u.numpy()) < dH
    qn = {uj: jnp.where(accept[:, None], q1[uj], q[uj])}
    lpn = jnp.where(accept, lp1, log_post(q))
    qn, _, _, _ = jax_swap_pass(qn, lpn, betas, jnp.tile(jnp.arange(K), C),
                                K, 0, jnp.asarray(swap_u.numpy()))
    cold = np.exp(np.asarray(qn[uj]))[::K]
    close(out[0], cold)
    assert 0 < int(np.asarray(accept).sum())


def test_svgd_median_matches_jnp_median():
    rng = np.random.default_rng(5)
    for n in (6, 7):
        x = rng.standard_normal((n, n))
        close(tsvgd._median(torch.as_tensor(x)), jnp.median(x), rtol=0)


@pytest.mark.parametrize("build,n,bandwidth", [
    (blr, 8, None), (gamma_exponential, 5, 0.7)])
def test_svgd_matches_jax(build, n, bandwidth):
    """20 iterations from the same fixed initial particles: the median
    heuristic at an even particle count (the median averages the two
    middle distances) and a fixed bandwidth over a positive latent."""
    out = {}
    for P, Alg, Infr in ((J, JSVGDAlgorithm, JSVGDInference),
                         (T, SVGDAlgorithm, SVGDInference)):
        m, obs, data = build(P)
        (u,) = model_latents(m, obs)
        size = n * int(np.prod(m[u].shape))
        m[u].factor._rand_gen = P.Fixed(np.random.default_rng(
            [0, 0]).uniform(0.2, 2.0, 2 * size))
        infr = Infr(Alg(model=m, observed=obs, num_particles=n,
                        num_iterations=20, step_size=0.1,
                        bandwidth=bandwidth))
        if P is J:
            out["jax"] = infr.run(key=jax.random.PRNGKey(0), **data)[u]
        else:
            out["port"] = infr.run(generator=gen(), **data)[u]
            assert infr.diagnostics["final_mean_abs_update"] > 0
    close(out["port"], out["jax"], rtol=1e-8)


# ---------------------------------------------------------------------
# whole chains (the port's alone): the JAX tests' oracles
# ---------------------------------------------------------------------

def test_sgld_minibatch_conjugate_gaussian_mean():
    """tests/inference/test_sgld.py:31-62 on 4 x 2000 draws (its 3000):
    the variance pins the N/B scale (unscaled, it would be 8x wider)."""
    N, B = 512, 64
    m, obs, data = gaussian_mean(T, N=N)
    y = data["y"]
    infr = SGLDInference(SGLDAlgorithm(
        model=m, observed=obs, num_samples=2000, num_burnin=500,
        num_chains=4, batch_size=B, step_size=2e-4, step_decay_gamma=0.0))
    samples = infr.run(generator=gen(0), y=y)
    post_var = 1.0 / (N + 1.0 / 100.0)
    post_mean = post_var * y.sum()
    draws = samples[m.mu.uuid].numpy().reshape(-1)
    assert abs(draws.mean() - post_mean) < 4 * np.sqrt(post_var)
    assert np.isclose(draws.var(), post_var, rtol=0.5), draws.var()
    assert infr.diagnostics["r_hat_max"] < 1.2
    assert np.isfinite(infr.diagnostics["final_minibatch_log_joint"]).all()
    assert float(infr.diagnostics["step_size_final"]) == pytest.approx(2e-4)


def test_psgld_preconditioning_handles_scale_mismatch():
    """tests/inference/test_sgld.py:97-131 on 4 x 2000 draws (its 3000)."""
    N = 256
    m, obs, data = gaussian_mean(T, N=N, s2=2.0, extra_latent=True)
    data["y"] = np.random.default_rng(2).standard_normal((N, 1)) * \
        np.sqrt(2.0) + 1.0
    infr = SGLDInference(SGLDAlgorithm(
        model=m, observed=obs, num_samples=2000, num_burnin=1000,
        num_chains=4, batch_size=64, step_size=2e-2, step_decay_gamma=0.0,
        preconditioning=True))
    samples = infr.run(generator=gen(2), **data)
    mu = samples[m.mu.uuid].numpy().reshape(-1)
    z = samples[m.z.uuid].numpy().reshape(-1)
    post_var = 1.0 / (N / 2.0 + 1.0 / 100.0)
    post_mean = post_var * data["y"].sum() / 2.0
    assert abs(mu.mean() - post_mean) < 5 * np.sqrt(post_var)
    assert abs(z.mean()) < 5e-2 and z.var() < 5e-4


def test_sgld_fullbatch_linear_regression():
    """tests/inference/test_sgld.py:65-94 on 4 x 2000 draws (its 4000)."""
    m, obs, data = blr(T, N=128)
    X, y = data["X"], data["y"]
    infr = SGLDInference(SGLDAlgorithm(
        model=m, observed=obs, num_samples=2000, num_burnin=500,
        num_chains=4, batch_size=None, step_size=4e-4,
        step_decay_gamma=0.0))
    draws = infr.run(generator=gen(1), **data)[m.w.uuid].numpy()
    Sigma = np.linalg.inv(X.T @ X / 0.25 + np.eye(3))
    mu = Sigma @ X.T @ y[:, 0] / 0.25
    draws = draws.reshape(-1, 3)
    np.testing.assert_allclose(draws.mean(0), mu, atol=0.08)
    np.testing.assert_allclose(draws.var(0), np.diag(Sigma), rtol=0.5,
                               atol=1e-3)


def test_sgld_predictive_determinism_and_errors():
    """tests/inference/test_sgld.py:134-151: thinning, the predictive's
    batch-sized data dim, the same chain from one seed, and the
    InferenceErrors of an oversized batch and of observed arrays whose
    data dimensions disagree."""
    N = 64
    m, obs, data = gaussian_mean(T, N=N, s2=1.0)

    def run(**kw):
        infr = SGLDInference(SGLDAlgorithm(
            model=m, observed=obs, num_samples=50, num_burnin=50,
            num_chains=2, batch_size=16, step_size=2e-4, thin=2, **kw))
        return infr, infr.run(generator=gen(3), **data)

    infr, s1 = run()
    _, s2 = run()
    assert tuple(s1[m.mu.uuid].shape) == (50, 2, 1)
    assert torch.equal(s1[m.mu.uuid], s2[m.mu.uuid])
    pred = infr.sample_predictive(generator=gen(4))
    assert tuple(pred[m.y.uuid].shape) == (100, 16, 1)
    with pytest.raises(InferenceError):
        SGLDInference(SGLDAlgorithm(model=m, observed=obs, batch_size=N + 1,
                                    num_samples=2, num_burnin=0)).run(
            generator=gen(5), **data)
    # two observed arrays on one symbolic dim, with 30 and 64 rows
    m2 = T.pkg.Model()
    m2.n = T.pkg.Variable()
    m2.mu = T.dist.Normal.define_variable(mean=0., variance=1., shape=(1,))
    m2.x = T.dist.Normal.define_variable(
        mean=T.ops.broadcast_to(m2.mu, (m2.n, 1)), variance=1.0,
        shape=(m2.n, 1))
    m2.y = T.dist.Normal.define_variable(
        mean=T.ops.broadcast_to(m2.mu, (m2.n, 1)), variance=1.0,
        shape=(m2.n, 1))
    with pytest.raises(InferenceError):
        SGLDInference(SGLDAlgorithm(model=m2, observed=[m2.x, m2.y],
                                    batch_size=8, num_samples=2,
                                    num_burnin=0)).run(
            generator=gen(5), x=data["y"][:30], y=data["y"])


def _bimodal(P):
    m = P.pkg.Model()
    m.x = P.dist.Normal.define_variable(mean=0., variance=25., shape=(1,))
    m.y = P.dist.Normal.define_variable(mean=P.ops.square(m.x),
                                        variance=0.25, shape=(1,))
    return m


def test_pt_mixes_across_modes_where_hmc_cannot():
    """tests/inference/test_tempering.py:29-59 on 4 x 400 draws (its
    600) at 8 leapfrog steps (its 16)."""
    y = np.array([4.0])
    m = _bimodal(T)
    hmc = HMCInference(HMCAlgorithm(model=m, observed=[m.y], num_samples=300,
                                    num_chains=4, num_warmup=200,
                                    num_leapfrog=8))
    x = hmc.run(y=y, generator=gen(0))[m.x.uuid].numpy()[:, :, 0]
    assert np.all((np.sign(x[:-1]) != np.sign(x[1:])).mean(axis=0) < 0.01)
    m2 = _bimodal(T)
    pt = ParallelTemperingInference(ParallelTemperingAlgorithm(
        model=m2, observed=[m2.y], num_samples=400, num_chains=4,
        num_temps=6, num_warmup=300, num_leapfrog=8))
    x2 = pt.run(y=y, generator=gen(0))[m2.x.uuid].numpy()[:, :, 0]
    pt_flips = (np.sign(x2[:-1]) != np.sign(x2[1:])).mean(axis=0)
    assert np.all(pt_flips > 0.05), pt_flips
    assert 0.35 < (x2 > 0).mean() < 0.65
    np.testing.assert_allclose(x2[x2 > 0].mean(), 2.0, atol=0.1)
    np.testing.assert_allclose(x2[x2 < 0].mean(), -2.0, atol=0.1)
    assert pt.diagnostics["swap_accept_rate"].min() > 0.2
    assert pt.diagnostics["swap_accept_rate"].shape == (5,)


def test_pt_constrained_latent_conjugate_and_predictive():
    """tests/inference/test_tempering.py:62-77 on 4 x 300 draws (its
    800): the posterior Gamma(2+N, 2+Σy) through the tempered Jacobian;
    then posterior-predictive draws of every cold chain."""
    m, obs, data = gamma_exponential(T)
    pt = ParallelTemperingInference(ParallelTemperingAlgorithm(
        model=m, observed=obs, num_samples=300, num_chains=4, num_temps=4,
        num_warmup=200, num_leapfrog=8))
    tau = pt.run(generator=gen(2), **data)[m.tau.uuid].numpy().reshape(-1)
    assert np.all(tau > 0)
    a, b = 2 + 60, 2 + data["y"].sum()
    np.testing.assert_allclose(tau.mean(), a / b, rtol=0.05)
    pred = pt.sample_predictive(generator=gen(3))
    assert tuple(pred[m.y.uuid].shape) == (1200, 60, 1)
    assert bool((pred[m.y.uuid] >= 0).all())


def test_pt_single_temperature_degenerates_to_hmc():
    """tests/inference/test_tempering.py:80-87, and the ValueError."""
    m = _bimodal(T)
    pt = ParallelTemperingInference(ParallelTemperingAlgorithm(
        model=m, observed=[m.y], num_samples=50, num_chains=2,
        num_temps=1, num_warmup=50))
    x = pt.run(y=np.array([4.0]), generator=gen(3))[m.x.uuid]
    assert tuple(x.shape) == (50, 2, 1) and bool(torch.isfinite(x).all())
    assert pt.diagnostics["swap_accept_rate"].shape == (0,)
    with pytest.raises(ValueError):
        ParallelTemperingAlgorithm(model=m, observed=[m.y], num_temps=0)


def test_svgd_conjugate_gaussian_mean():
    """tests/inference/test_svgd.py:15-40: the particles carry the
    posterior's spread, not only its mean."""
    N, s2, tau2 = 60, 2.0, 50.0
    y = np.random.default_rng(0).standard_normal((N, 1)) * np.sqrt(s2) + 1.5
    m = T.pkg.Model()
    m.mu = T.dist.Normal.define_variable(mean=0., variance=tau2, shape=(1,))
    m.y = T.dist.Normal.define_variable(
        mean=T.ops.broadcast_to(m.mu, (N, 1)),
        variance=T.ops.broadcast_to(T.pkg.Variable(value=s2), (N, 1)),
        shape=(N, 1))
    infr = SVGDInference(SVGDAlgorithm(model=m, observed=[m.y],
                                       num_particles=100,
                                       num_iterations=800, step_size=0.1))
    z = infr.run(y=y, generator=gen(0))[m.mu.uuid].numpy().reshape(-1)
    post_var = 1.0 / (N / s2 + 1.0 / tau2)
    post_mean = post_var * y.sum() / s2
    assert z.shape == (100,)
    assert abs(z.mean() - post_mean) < 3 * np.sqrt(post_var)
    assert np.isclose(z.var(), post_var, rtol=0.4), (z.var(), post_var)


def test_svgd_single_particle_is_map():
    """tests/inference/test_svgd.py:71-89."""
    N = 40
    m, obs, data = conjugate_gaussian(T, N=N, s2=1.0)
    data["y"] = np.random.default_rng(2).standard_normal((N, 1)) + 2.0
    infr = SVGDInference(SVGDAlgorithm(model=m, observed=obs,
                                       num_particles=1, num_iterations=600,
                                       step_size=0.2, bandwidth=1.0))
    z = float(infr.run(generator=gen(2), **data)[m.mu.uuid].reshape(-1)[0])
    post_var = 1.0 / (N + 0.01)
    assert abs(z - post_var * data["y"].sum()) < 0.05


def test_svgd_over_gp_module_and_predictive():
    """tests/inference/test_mcmc_over_modules.py:54-63 (the GP's noise
    variance by 16 particles), then tests/inference/test_svgd.py:92-114's
    predictive draws (one per particle), the same under one seed."""
    m, obs, data = gp_noise(T)
    infr = SVGDInference(SVGDAlgorithm(model=m, observed=obs,
                                       num_particles=16,
                                       num_iterations=150, step_size=0.05))
    (nv,) = infr.run(generator=gen(1), **data).values()
    assert tuple(nv.shape) == (16, 1)
    assert 0.003 < float(nv.mean()) < 0.06, float(nv.mean())
    assert all(p.grad is None
               for p in infr.params.trainable_params().values())
    N = 30
    m, obs, data = conjugate_gaussian(T, N=N, s2=1.0, tau2=50.0)
    data["y"] = np.random.default_rng(5).standard_normal((N, 1)) + 1.0
    infr = SVGDInference(SVGDAlgorithm(model=m, observed=obs,
                                       num_particles=40,
                                       num_iterations=300, step_size=0.1))
    p1 = infr.run(generator=gen(5), **data)[m.mu.uuid]
    yp = infr.sample_predictive(generator=gen(6))[m.y.uuid]
    assert tuple(yp.shape) == (40, N, 1)
    assert abs(float(yp.mean()) - data["y"].mean()) < 0.5
    p2 = SVGDInference(SVGDAlgorithm(
        model=m, observed=obs, num_particles=40, num_iterations=300,
        step_size=0.1)).run(generator=gen(5), **data)[m.mu.uuid]
    assert torch.equal(p1, p2)
