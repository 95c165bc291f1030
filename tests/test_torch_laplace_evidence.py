"""Laplace and thermodynamic integration against the JAX package.

The port's ``laplace_approximation`` at the JAX MAP fit's point (its
parameters carried across by name path) gives JAX's mean, covariance and
log evidence at rtol 1e-10 (linear-Gaussian) and 1e-8 (the SVGP's bound,
through its wide data path); it keeps the fused gram off, goes through
K1's ``autograd.Function`` in float32, requires MAP and refuses a
Hessian that is not positive definite with JAX's message. The power
posterior's whole ``compute`` on JAX's own draws (replayed from its key
schedule through ``FixedRandomGenerator``) gives JAX's samples and every
diagnostic at rtol 1e-10; whole chains of the port alone meet the JAX
tests' closed-form evidences (``tests/inference/test_evidence.py``) on
shorter chains."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import betaln, gammaln

from mxfusion_tpu import inference as jinference
from mxfusion_tpu.common.exceptions import InferenceError as JInferenceError
from mxfusion_tpu.inference import inference_alg as jalg
from mxfusion_tpu.modules import SVGPRegression as JSVGPRegression

from mxfusion_tpu_torch import inference as tinference
from mxfusion_tpu_torch.common.exceptions import InferenceError
from mxfusion_tpu_torch.components.distributions.random_gen import \
    FixedRandomGenerator
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.ops import cuda_kernels, fused_gram
from mxfusion_tpu_torch.util.carryover import load_state
from tests.test_torch_hmc_chees import (  # noqa: F401
    J as J_, T as T_, _jax_in_float64, _on_the_cpu_in_float64,
    _one_torch_thread, blr, close, gamma_exponential, gp_noise,
    model_latents)

J = SimpleNamespace(**vars(J_), inf=jinference,
                    SVGPRegression=JSVGPRegression)
T = SimpleNamespace(**vars(T_), inf=tinference,
                    SVGPRegression=SVGPRegression)


def carried(jinf, tinf, data):
    """The port's inference at the JAX inference's parameters."""
    tinf.initialize(**data)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    return tinf


def map_pair(build, max_iter, learning_rate, **kw):
    """JAX's MAP fit of ``build``'s model and the port's MAP inference at
    its parameters; (JAX inference, port inference, data)."""
    jm, jobs, data = build(J, **kw)
    jinf = J.inf.GradBasedInference(J.inf.MAP(model=jm, observed=jobs),
                                    dtype="float64")
    jinf.run(max_iter=max_iter, learning_rate=learning_rate,
             key=jax.random.PRNGKey(0), **data)
    tm, tobs, _ = build(T, **kw)
    tinf = T.inf.GradBasedInference(T.inf.MAP(model=tm, observed=tobs),
                                    dtype="float64", device="cpu")
    return jinf, carried(jinf, tinf, data), data


def svgp_noise(P, N=48, M=8):
    """tests/inference/test_laplace.py:84-110: SVGP regression with a
    Gamma(2, 20) noise latent, N ≥ 4M (the bound's wide data path)."""
    rng = np.random.default_rng(2)
    X = np.sort(rng.random((N, 1)) * 4, 0)
    Y = np.sin(2 * X) + rng.standard_normal((N, 1)) * 0.1
    m = P.pkg.Model()
    m.n = P.pkg.Variable()
    m.X = P.pkg.Variable(shape=(m.n, 1))
    m.noise_var = P.dist.Gamma.define_variable(alpha=2.0, beta=20.0,
                                               shape=(1,))
    m.Y = P.SVGPRegression.define_variable(
        X=m.X, kernel=P.RBF(input_dim=1, variance=1.0, lengthscale=1.0),
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=P.pkg.Variable(
            shape=(M, 1), initial_value=np.linspace(0, 4, M)[:, None]))
    return m, [m.X, m.Y], {"X": X, "Y": Y}


def check_same_result(jres, tres, rtol):
    assert tres.uuids == sorted(tres.uuids) and \
        len(tres.uuids) == len(jres.uuids)
    for uj, ut in zip(jres.uuids, tres.uuids):
        close(tres.mean[ut], jres.mean[uj], rtol=rtol)
    close(tres.cov, jres.cov, rtol=rtol)
    close(tres.log_evidence, jres.log_evidence, rtol=rtol)


# ---------------------------------------------------------------------
# Laplace
# ---------------------------------------------------------------------

@pytest.mark.parametrize("build,max_iter,lr,rtol", [
    (blr, 400, 0.05, 1e-10),
    (svgp_noise, 100, 0.03, 1e-8)], ids=["linear_gaussian", "svgp"])
def test_laplace_matches_jax(build, max_iter, lr, rtol):
    jinf, tinf, data = map_pair(build, max_iter, lr)
    check_same_result(jinference.laplace_approximation(jinf, **data),
                      tinference.laplace_approximation(tinf, **data), rtol)


def test_laplace_is_exact_on_linear_gaussian():
    """The oracle of test_laplace.py:42-59 with the location set to the
    closed-form mode: the linear-Gaussian posterior's covariance and the
    exact marginal likelihood y ~ N(0, XXᵀ + σ²I)."""
    from scipy import stats
    tm, obs, data = blr(T)
    X, y = data["X"], data["y"]
    N, D = X.shape
    Sigma = np.linalg.inv(X.T @ X / 0.25 + np.eye(D))
    mu = Sigma @ X.T @ y / 0.25
    tinf = T.inf.GradBasedInference(T.inf.MAP(model=tm, observed=obs),
                                    dtype="float64", device="cpu")
    tinf.initialize(**data)
    tinf.params[tinf.inference_algorithm.posterior[tm.w].factor
                .location] = mu
    res = tinference.laplace_approximation(tinf, **data)
    mean, cov = res.marginal(tm.w)
    close(mean, mu, rtol=1e-12)
    close(cov, Sigma, rtol=1e-10)
    exact = stats.multivariate_normal.logpdf(
        y[:, 0], np.zeros(N), X @ X.T + 0.25 * np.eye(N))
    close(res.log_evidence, exact, rtol=1e-10)


def test_laplace_disables_fused_gram(monkeypatch):
    """test_laplace.py:131-171: with the gate forced open, the bound's
    fused arm would call K2 (here a stand-in that raises); Laplace
    materializes Kuf for its pass and gives the materialized result."""
    jinf, tinf, data = map_pair(svgp_noise, 100, 0.03)
    ref = tinference.laplace_approximation(tinf, **data)

    def boom(*args, **kwargs):
        raise AssertionError("fused gram op engaged inside a Laplace pass")

    monkeypatch.setattr(fused_gram, "supported", lambda *a, **k: True)
    monkeypatch.setattr(fused_gram, "fused_linv_rbf_gram", boom)
    loss = T.inf.create_executor(tinf.inference_algorithm, tinf.params)
    with pytest.raises(AssertionError, match="fused gram"):
        loss(tinf.params.trainable_params(), tinf.params.fixed_params(),
             [data["X"], data["Y"]], torch.Generator())
    res = tinference.laplace_approximation(tinf, **data)
    check_same_result(ref, res, 1e-12)
    assert fused_gram.enabled()


def test_float32_gp_laplace_goes_through_k1_function(monkeypatch):
    """A float32 GPRegression's gram goes through K1's
    ``autograd.Function`` (on the CPU its plain version); the Hessian
    runs through its recompute backward and lands within 1e-3 of the
    float64 result (where the gram is plain torch)."""
    results, calls = {}, []
    forward = cuda_kernels._RbfGram.forward

    def counted(ctx, *args):
        calls.append(args[0].dtype)
        return forward(ctx, *args)

    monkeypatch.setattr(cuda_kernels._RbfGram, "forward",
                        staticmethod(counted))
    for dtype in ("float64", "float32"):
        tm, obs, data = gp_noise(T)
        tinf = T.inf.GradBasedInference(T.inf.MAP(model=tm, observed=obs),
                                        dtype=dtype, device="cpu")
        tinf.initialize(**data)
        loc = tinf.inference_algorithm.posterior[tm.noise_var].factor.location
        tinf.params[loc] = np.full(1, 0.012)
        results[dtype] = tinference.laplace_approximation(tinf, **data)
    assert calls == [torch.float32]
    f32, f64 = results["float32"], results["float64"]
    assert f32.cov.dtype == torch.float32
    assert abs(f32.log_evidence - f64.log_evidence) <= \
        1e-3 * abs(f64.log_evidence)
    close(f32.cov.double(), f64.cov, rtol=1e-3)


def test_laplace_requires_map():
    m, obs, data = gamma_exponential(T, N=5)
    q = T.inf.create_Gaussian_meanfield(model=m, observed=obs)
    infr = T.inf.GradBasedInference(T.inf.StochasticVariationalInference(
        num_samples=2, model=m, posterior=q, observed=obs), device="cpu")
    infr.run(max_iter=2, learning_rate=0.1, **data)
    with pytest.raises(InferenceError, match="PointMass"):
        tinference.laplace_approximation(infr, **data)


def student_t_modes(P):
    """A Student-t location between two far clusters of data: at the
    midpoint -log p curves downward."""
    y = np.concatenate([np.full((5, 1), -10.0), np.full((5, 1), 10.0)])
    m = P.pkg.Model()
    m.mu = P.dist.Normal.define_variable(mean=0., variance=100., shape=(1,))
    m.y = P.dist.StudentT.define_variable(
        degrees_of_freedom=1.0, location=P.ops.broadcast_to(m.mu, (10, 1)),
        scale=1.0, shape=(10, 1))
    return m, [m.y], {"y": y}


def test_indefinite_hessian_raises_as_jax():
    messages = []
    for P, Error in ((J, JInferenceError), (T, InferenceError)):
        m, obs, data = student_t_modes(P)
        kw = {} if P is J else {"device": "cpu"}
        infr = P.inf.GradBasedInference(P.inf.MAP(model=m, observed=obs),
                                        dtype="float64", **kw)
        infr.initialize(**data)
        infr.params[infr.inference_algorithm.posterior[m.mu].factor
                    .location] = np.zeros(1)
        with pytest.raises(Error, match="not positive definite") as err:
            P.inf.laplace_approximation(infr, **data)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------
# thermodynamic integration
# ---------------------------------------------------------------------

def jax_sweep_draws(key, shapes, R, num_warmup, num_samples):
    """The draws the JAX package's ``PowerPosteriorAlgorithm.compute``
    takes from ``key`` (evidence.py:73-74, 139-152, 168, 219-221,
    238-242), flattened in the order the port's sweep asks for them:
    per sweep, each latent's momentum, the acceptance uniforms, the swap
    uniforms."""
    ctx = jalg.RuntimeContext(key)
    ctx.next_key()                       # the prior draws' key
    out = []
    for n in (num_warmup, num_samples):
        for k in jax.random.split(ctx.next_key(), n):
            ks, kw = jax.random.split(k)
            kp, ka = jax.random.split(ks)
            for kk, shape in zip(jax.random.split(kp, len(shapes)), shapes):
                out.append(jax.random.normal(kk, shape, dtype=jnp.float64))
            out.append(jax.random.uniform(ka, (R,), dtype=jnp.float64))
            out.append(jax.random.uniform(kw, (R,), dtype=jnp.float64))
    return np.concatenate([np.asarray(a).ravel() for a in out])


def ti_side(P, build, C, K, W, S, L, draws=None):
    """One package's power-posterior run of ``build``'s model, the prior
    draws fixed alike; the port's sweeps on ``draws``."""
    m, obs, data = build(P)
    uuids = model_latents(m, obs)
    for i, u in enumerate(uuids):
        n = C * K * int(np.prod([s for s in m[u].shape if isinstance(s, int)]))
        m[u].factor._rand_gen = P.Fixed(
            np.random.default_rng([0, i]).uniform(0.2, 2.0, n))
    kw = dict(model=m, observed=obs, num_samples=S, num_warmup=W,
              num_chains=C, num_temps=K, num_leapfrog=L, step_size=0.1)
    if P is J:
        infr = J.inf.PowerPosteriorInference(
            J.inf.PowerPosteriorAlgorithm(**kw), dtype="float64")
        infr.run(key=jax.random.PRNGKey(3), **data)
    else:
        infr = T.inf.PowerPosteriorInference(
            T.inf.PowerPosteriorAlgorithm(
                rand_gen=FixedRandomGenerator(draws), **kw),
            dtype="float64", device="cpu")
        infr.run(**data)
    return m, uuids, infr


@pytest.mark.parametrize("build", [gamma_exponential, gp_noise],
                         ids=["gamma_exponential", "gp_noise"])
def test_power_posterior_compute_matches_jax(build):
    """2 warmup and 2 sampling sweeps of 2 chains × 4 rungs, L = 3: the
    port on JAX's draws gives JAX's posterior-rung samples and every
    diagnostic. Over the GP each potential evaluation builds Kxx through
    K1's Function."""
    C, K, W, S, L = 2, 4, 2, 2, 3
    mj, uj, jinf = ti_side(J, build, C, K, W, S, L)
    shapes = [(C * K,) + tuple(mj[u].shape) for u in uj]
    draws = jax_sweep_draws(jax.random.PRNGKey(3), shapes, C * K, W, S)
    mt, ut, tinf = ti_side(T, build, C, K, W, S, L, draws)
    for a, b in zip(uj, ut):
        close(tinf._samples[b], jinf._samples[a])
    for k, v in jinf.diagnostics.items():
        if k == "r_hat":             # by latent; empty below 4 draws
            port = {mt[u].name: r for u, r in tinf.diagnostics[k].items()}
            assert sorted(port) == sorted(mj[u].name for u in v)
            for u, r in v.items():
                close(port[mj[u].name], r)
        else:
            close(tinf.diagnostics[k], v)
    assert tinf.log_evidence == float(tinf.diagnostics["log_evidence"])
    # one evaluation at the start, then L + 1 per sweep
    assert tinf.diagnostics["potential_evaluations"] == 1 + (L + 1) * (W + S)


def test_ti_evidence_gamma_exponential():
    """test_evidence.py:21-41's oracle and tolerances, 150 + 200 sweeps
    (of 400 + 600)."""
    m, obs, data = gamma_exponential(T)
    y = data["y"]
    N = y.shape[0]
    infr = T.inf.PowerPosteriorInference(T.inf.PowerPosteriorAlgorithm(
        model=m, observed=obs, num_samples=200, num_warmup=150,
        num_chains=2, num_temps=16), dtype="float64", device="cpu")
    s = infr.run(generator=torch.Generator().manual_seed(0), **data)
    a, b = 2.0, 2.0
    exact = (a * np.log(b) + gammaln(a + N) - gammaln(a)
             - (a + N) * np.log(b + y.sum()))
    np.testing.assert_allclose(infr.log_evidence, exact, atol=0.15)
    tau = s[m.tau.uuid].numpy().reshape(-1)
    np.testing.assert_allclose(tau.mean(), (a + N) / (b + y.sum()),
                               rtol=0.05)
    assert infr.diagnostics["swap_accept_rate"].min() > 0.3


def test_ti_evidence_beta_bernoulli():
    """test_evidence.py:44-58's oracle and tolerance, 150 + 200 sweeps."""
    rng = np.random.default_rng(2)
    N = 40
    y = (rng.random((N, 1)) < 0.3).astype(np.float64)
    k = y.sum()
    m = T.pkg.Model()
    m.p = T.dist.Beta.define_variable(alpha=2.0, beta=2.0, shape=(1,))
    m.y = T.dist.Bernoulli.define_variable(
        prob_true=T.ops.broadcast_to(m.p, (N, 1)), shape=(N, 1))
    infr = T.inf.PowerPosteriorInference(T.inf.PowerPosteriorAlgorithm(
        model=m, observed=[m.y], num_samples=200, num_warmup=150,
        num_chains=2, num_temps=16), dtype="float64", device="cpu")
    infr.run(generator=torch.Generator().manual_seed(1), y=y)
    exact = betaln(2 + k, 2 + N - k) - betaln(2, 2)
    np.testing.assert_allclose(infr.log_evidence, exact, atol=0.15)


def test_ti_requires_two_rungs():
    m, obs, _ = gamma_exponential(T, N=5)
    with pytest.raises(ValueError, match="num_temps"):
        T.inf.PowerPosteriorAlgorithm(model=m, observed=obs, num_temps=1)
