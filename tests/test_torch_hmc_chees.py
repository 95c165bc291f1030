"""HMC, ChEES-HMC and the samplers' shared scaffolding against the JAX
package.

The same model is built in both packages, each latent's prior draws
from a ``FixedRandomGenerator`` over the same numpy buffer, and both
executors build the runtime env from the same data. The helpers
(support bijectors, ``sum_log_pdf_terms``, the prior initialization, the
diagnostics) and the potential and its gradient agree at rtol 1e-10 in
float64; one transition of each sampler on explicit draws (momentum,
log u, trajectory fraction) agrees with the same step written out from
the JAX package's lines on its own model's ``log_pdf_terms`` and
``jax.grad``. Whole chains are the port's alone, held to the conjugate
oracles of ``tests/inference/test_{hmc,chees,mcmc_over_modules}.py``
on shorter chains."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxfusion_tpu as mj
from mxfusion_tpu.components import distributions as jdist
from mxfusion_tpu.components.distributions.gp.kernels import RBF as JRBF
from mxfusion_tpu.components.distributions.random_gen import \
    FixedRandomGenerator as JFixed
from mxfusion_tpu.components.functions import operators as jops
from mxfusion_tpu.inference import hmc as jhmc
from mxfusion_tpu.inference import inference_alg as jalg
from mxfusion_tpu.modules import GPRegression as JGPRegression

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.common.exceptions import InferenceError
from mxfusion_tpu_torch.components import distributions as tdist
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.components.distributions.random_gen import \
    FixedRandomGenerator
from mxfusion_tpu_torch.components.functions import operators as tops
from mxfusion_tpu_torch.inference import chees as tchees
from mxfusion_tpu_torch.inference import hmc as thmc
from mxfusion_tpu_torch.inference import inference_alg as talg
from mxfusion_tpu_torch.inference import (
    ChEESHMCAlgorithm, ChEESHMCInference, HMCAlgorithm, HMCInference,
    effective_sample_size, potential_scale_reduction)
from mxfusion_tpu_torch.modules import GPRegression
from tests.test_torch_meanfield import _on_the_cpu_in_float64  # noqa: F401
from tests.test_torch_svgp_classification import jax_f64

RTOL = 1e-10

J = SimpleNamespace(pkg=mj, dist=jdist, ops=jops, RBF=JRBF,
                    GPRegression=JGPRegression, Fixed=JFixed, hmc=jhmc,
                    alg=jalg)
T = SimpleNamespace(pkg=mt, dist=tdist, ops=tops, RBF=RBF,
                    GPRegression=GPRegression, Fixed=FixedRandomGenerator,
                    hmc=thmc, alg=talg)


@pytest.fixture(autouse=True, scope="module")
def _jax_in_float64():
    with jax_f64():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A chain is thousands of small ops: torch's intra-op threads only
    contend with the suite's other workers for the cores (a whole run
    on six workers took ten times as long with them)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------
# the models of the JAX package's sampler tests, built alike in either
# package: (model, observed variables, data by name)
# ---------------------------------------------------------------------

def conjugate_gaussian(P, N=30, s2=4.0, tau2=100.0):
    y = np.random.default_rng(0).standard_normal((N, 1)) * np.sqrt(s2) + 3.0
    m = P.pkg.Model()
    m.mu = P.dist.Normal.define_variable(mean=0., variance=tau2, shape=(1,))
    m.y = P.dist.Normal.define_variable(
        mean=P.ops.broadcast_to(m.mu, (N, 1)),
        variance=P.ops.broadcast_to(P.pkg.Variable(value=s2), (N, 1)),
        shape=(N, 1))
    return m, [m.y], {"y": y}


def blr(P, N=40, D=3, s2=0.25, correlated=False):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((N, D))
    if correlated:
        X = X @ (np.eye(D) + 0.5 * rng.standard_normal((D, D)))
    y = X @ np.array([[1.0], [-0.5], [0.25]]) + \
        rng.standard_normal((N, 1)) * np.sqrt(s2)
    m = P.pkg.Model()
    m.X = P.pkg.Variable(shape=(N, D))
    m.w = P.dist.Normal.define_variable(
        mean=P.ops.broadcast_to(P.pkg.Variable(value=0.), (D, 1)),
        variance=P.ops.broadcast_to(P.pkg.Variable(value=1.), (D, 1)),
        shape=(D, 1))
    m.f = P.ops.dot(m.X, m.w)
    m.y = P.dist.Normal.define_variable(
        mean=m.f, variance=P.ops.broadcast_to(P.pkg.Variable(value=s2),
                                              (N, 1)),
        shape=(N, 1))
    return m, [m.X, m.y], {"X": X, "y": y}


def gamma_exponential(P, N=60, seed=1):
    y = np.random.default_rng(seed).exponential(1.0 / 1.7, (N, 1))
    m = P.pkg.Model()
    m.tau = P.dist.Gamma.define_variable(alpha=2.0, beta=2.0, shape=(1,))
    m.y = P.dist.Exponential.define_variable(
        rate=P.ops.broadcast_to(m.tau, (N, 1)), shape=(N, 1))
    return m, [m.y], {"y": y}


def beta_bernoulli(P, N=50):
    y = (np.random.default_rng(0).random((N, 1)) < 0.3).astype(np.float64)
    m = P.pkg.Model()
    m.p = P.dist.Beta.define_variable(alpha=2.0, beta=2.0, shape=(1,))
    m.y = P.dist.Bernoulli.define_variable(
        prob_true=P.ops.broadcast_to(m.p, (N, 1)), shape=(N, 1))
    return m, [m.y], {"y": y}


def dirichlet_categorical(P, N=90, K=3):
    labels = np.random.default_rng(2).choice(K, size=N, p=[0.6, 0.3, 0.1])
    Y = np.eye(K)[labels]
    m = P.pkg.Model()
    m.p = P.dist.Dirichlet.define_variable(
        alpha=P.pkg.Variable(value=np.full(K, 2.0)), shape=(K,))
    m.y = P.dist.Categorical.define_variable(
        log_prob=P.ops.broadcast_to(P.ops.log(m.p), (N, K)), num_classes=K,
        one_hot_encoding=True, normalization=True, shape=(N, K))
    return m, [m.y], {"y": Y}


def gp_noise(P, N=40):
    """tests/inference/test_mcmc_over_modules.py:21-33: the noise
    variance of an exact GP under a Gamma(2, 20) prior."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.random((N, 1)) * 4, 0)
    Y = np.sin(2 * X) + rng.standard_normal((N, 1)) * 0.1
    m = P.pkg.Model()
    m.n = P.pkg.Variable()
    m.X = P.pkg.Variable(shape=(m.n, 1))
    m.noise_var = P.dist.Gamma.define_variable(alpha=2.0, beta=20.0,
                                               shape=(1,))
    m.Y = P.GPRegression.define_variable(
        X=m.X, kernel=P.RBF(input_dim=1, variance=1.0, lengthscale=1.0),
        noise_var=m.noise_var, shape=(m.n, 1))
    return m, [m.X, m.Y], {"X": X, "Y": Y}


MODELS = {"conjugate_gaussian": conjugate_gaussian, "blr": blr,
          "gamma_exponential": gamma_exponential,
          "beta_bernoulli": beta_bernoulli,
          "dirichlet_categorical": dirichlet_categorical,
          "gp_noise": gp_noise}


def model_latents(m, observed):
    return [v.uuid for v in m.get_latent_variables(
        [v.uuid for v in observed])]


def one_side(P, build, C, seed=0):
    """One package's view of a model: its env from the executor, the
    support bijectors, C chains from the fixed prior draws (sampling
    space) and the potential ``U(q) = -log p``."""
    m, observed, data = build(P)
    uuids = model_latents(m, observed)
    for i, u in enumerate(uuids):
        v = m[u]
        n = C * int(np.prod([s for s in v.shape if isinstance(s, int)]))
        v.factor._rand_gen = P.Fixed(np.random.default_rng(
            [seed, i]).uniform(0.2, 2.0, 2 * n))
    alg = P.hmc.HMCAlgorithm(model=m, observed=observed, num_chains=C)
    inf = P.hmc.HMCInference(alg)
    inf.initialize(**data)
    executor = P.alg.create_sampling_executor(alg, inf.params)
    env = executor.build_env(inf.params.trainable_params(),
                             inf.params.fixed_params(),
                             [data[v.name] for v in observed])
    if P is J:
        ctx = jalg.RuntimeContext(jax.random.PRNGKey(0))
        q = jhmc.init_chains_from_prior(m, env, ctx.next_key(), uuids, C)
    else:
        ctx = talg.RuntimeContext(gen())
        q = thmc.init_chains_from_prior(m, env, gen(), uuids, C)
    bij = P.hmc.make_support_transforms(m, uuids)
    z = bij.unconstrain(q) if bij is not None else q
    dtype = q[uuids[0]].dtype

    if P is J:
        def neg_logp(q):
            e = jalg.VariableEnv(env)
            e.update(bij.constrain(q) if bij is not None else q)
            lp = jhmc.sum_log_pdf_terms(m.log_pdf_terms(e, ctx=ctx), dtype)
            if bij is not None:
                lp = lp + bij.log_jacobian(q).astype(dtype)
            return -lp
    else:
        log_post = thmc.log_posterior(m, env, ctx, bij, dtype)

        def neg_logp(q):
            return -log_post(q)
    return SimpleNamespace(m=m, observed=observed, data=data, uuids=uuids,
                           env=env, ctx=ctx, q=q, z=z, bij=bij,
                           neg_logp=neg_logp, dtype=dtype)


@pytest.fixture(scope="module")
def sides():
    """{model name: (JAX side, port side)}, three chains each."""
    out = {}
    for name, build in MODELS.items():
        out[name] = (one_side(J, build, 3), one_side(T, build, 3))
    return out


def close(a, b, rtol=RTOL, atol=0.0):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def by_uuid(port, ref, rtol=RTOL, atol=0.0, sides=None):
    """Dicts by uuid agree entry by entry: by key, or, for the two
    packages' own uuids, by the variables' names in ``sides``."""
    if sides is not None:
        port = {sides[1].m[u].name: v for u, v in port.items()}
        ref = {sides[0].m[u].name: v for u, v in ref.items()}
    assert sorted(port) == sorted(ref)
    for u in ref:
        close(port[u], ref[u], rtol, atol)


def to_torch(d):
    return {u: torch.as_tensor(np.asarray(v)) for u, v in d.items()}


# ---------------------------------------------------------------------
# the shared scaffolding
# ---------------------------------------------------------------------

@pytest.mark.parametrize("support", ["positive", "unit_interval",
                                     "simplex"])
def test_support_transforms_match_jax(support):
    rng = np.random.default_rng(0)
    if support == "simplex":
        x = rng.dirichlet(np.ones(4) * 1.5, size=(5,))
    elif support == "unit_interval":
        x = rng.uniform(0.0, 1.0, (5, 2))
        x[0, 0] = 0.0     # the boundary guard clips by eps
    else:
        x = rng.gamma(2.0, 1.0, (5, 2))
        x[0, 0] = 0.0     # ... and by tiny
    tj = jhmc.SupportTransforms({"u": support})
    tt = thmc.SupportTransforms({"u": support})
    zj = tj.unconstrain({"u": jnp.asarray(x)})
    zt = tt.unconstrain({"u": torch.as_tensor(x)})
    by_uuid(zt, zj)
    z = rng.standard_normal(np.asarray(zj["u"]).shape)
    by_uuid(tt.constrain({"u": torch.as_tensor(z)}),
            tj.constrain({"u": jnp.asarray(z)}))
    close(tt.log_jacobian({"u": torch.as_tensor(z)}),
          tj.log_jacobian({"u": jnp.asarray(z)}))


def test_sum_log_pdf_terms_matches_jax():
    rng = np.random.default_rng(1)
    terms = [rng.standard_normal((1,)), rng.standard_normal((4,)),
             rng.standard_normal((4,)).astype(np.float32),
             rng.standard_normal((1,))]
    for dtype_j, dtype_t in ((jnp.float64, torch.float64),
                             (jnp.float32, torch.float32)):
        ref = jhmc.sum_log_pdf_terms([jnp.asarray(t) for t in terms],
                                     dtype_j)
        out = thmc.sum_log_pdf_terms([torch.as_tensor(t) for t in terms],
                                     dtype_t)
        assert out.dtype == dtype_t and tuple(out.shape) == (4,)
        close(out, ref, rtol=RTOL if dtype_t == torch.float64 else 1e-6)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prior_init_and_potential_match_jax(sides, name):
    """The chains' prior initialization, and the potential and its
    gradient at it (sampling space), at rtol 1e-10."""
    js, ts = sides[name]
    by_uuid(ts.q, js.q, sides=sides[name])
    by_uuid(ts.z, js.z, sides=sides[name])
    U_j = js.neg_logp(js.z)
    g_j = jax.grad(lambda q: jnp.sum(js.neg_logp(q)))(js.z)
    U_t, g_t = thmc.value_and_grad(ts.neg_logp, ts.z)
    assert tuple(U_t.shape) == (3,)
    close(U_t, U_j)
    by_uuid(g_t, g_j, sides=sides[name])


def test_diagnostics_match_jax():
    x = np.random.default_rng(2).standard_normal((64, 4, 3)).cumsum(0)
    close(effective_sample_size(torch.as_tensor(x)),
          jhmc.effective_sample_size(x))
    close(potential_scale_reduction(torch.as_tensor(x)),
          jhmc.potential_scale_reduction(x))
    assert isinstance(effective_sample_size(x[:, :, 0]), float)


def test_effective_sample_size_estimator():
    """tests/inference/test_hmc.py:160-183's oracle, at S = 1000."""
    rng = np.random.default_rng(7)
    S, C = 1000, 4
    iid = rng.standard_normal((S, C))
    ess_iid = effective_sample_size(iid)
    assert 0.6 * S * C < ess_iid < 1.4 * S * C, ess_iid
    rho, e = 0.9, rng.standard_normal((S, C))
    ar = np.zeros((S, C))
    for t in range(1, S):
        ar[t] = rho * ar[t - 1] + np.sqrt(1 - rho ** 2) * e[t]
    expected = S * C * (1 - rho) / (1 + rho)
    assert 0.5 * expected < effective_sample_size(ar) < 2.0 * expected
    assert effective_sample_size(
        rng.standard_normal((300, 2, 3))).shape == (3,)


# ---------------------------------------------------------------------
# one transition on explicit draws, against the JAX lines
# ---------------------------------------------------------------------

def jax_hmc_transition(neg_logp, q, p0, log_u, eps, inv_mass, L):
    """mxfusion_tpu/inference/hmc.py:266-303 on explicit draws."""
    grad_U = jax.grad(lambda q: jnp.sum(neg_logp(q)))
    C = log_u.shape[0]

    def kinetic(p):
        k = jnp.zeros((C,), dtype=log_u.dtype)
        for u, v in p.items():
            k = k + 0.5 * jhmc._per_chain_sum(v ** 2 * inv_mass[u])
        return k

    g = grad_U(q)
    p = {u: p0[u] - 0.5 * eps * g[u] for u in p0}
    q1 = q
    for i in range(L):
        q1 = {u: q1[u] + eps * inv_mass[u] * p[u] for u in q1}
        g = grad_U(q1)
        scale = jnp.where(i == L - 1, 0.5, 1.0)
        p = {u: p[u] - scale * eps * g[u] for u in p}
    dH = neg_logp(q) + kinetic(p0) - (neg_logp(q1) + kinetic(p))
    accept = log_u < dH
    qn = {u: jnp.where(accept.reshape((C,) + (1,) * (q[u].ndim - 1)),
                       q1[u], q[u]) for u in q}
    accept_prob = jnp.minimum(1.0, jnp.exp(dH))
    accept_prob = jnp.where(jnp.isnan(accept_prob), 0.0, accept_prob)
    return qn, accept_prob, q1, p


def explicit_draws(pair, seed):
    """Momentum, a diagonal inverse metric and log u for three chains:
    JAX's dicts by JAX's uuids, the port's (as tensors) by the port's."""
    js, ts = pair
    rng = np.random.default_rng(seed)
    port_uuid = {ts.m[u].name: u for u in ts.z}
    p0 = {u: rng.standard_normal(np.shape(v)) for u, v in js.z.items()}
    mass = {u: rng.uniform(0.5, 2.0, np.shape(v)[1:])
            for u, v in js.z.items()}
    log_u = np.log(rng.uniform(size=(3,)))

    def port(d):
        return {port_uuid[js.m[u].name]: torch.as_tensor(v)
                for u, v in d.items()}

    def jaxs(d):
        return {u: jnp.asarray(v) for u, v in d.items()}
    return jaxs(p0), jaxs(mass), port(p0), port(mass), log_u


@pytest.mark.parametrize("name,eps", [("blr", 0.02), ("gamma_exponential",
                                                      0.5),
                                      ("dirichlet_categorical", 0.8),
                                      ("gp_noise", 0.3)])
def test_hmc_transition_matches_jax(sides, name, eps):
    """Leapfrog and Metropolis step (hmc.py:266-303): the new state, the
    acceptance probabilities, and the carried potential and gradient
    equal the new state's."""
    js, ts = sides[name]
    p0_j, mass_j, p0, mass, log_u = explicit_draws(sides[name], 3)
    L = 5
    qn_j, acc_j, q1_j, p1_j = jax_hmc_transition(
        js.neg_logp, js.z, p0_j, jnp.asarray(log_u), eps, mass_j, L)

    def potential(q):
        return thmc.value_and_grad(ts.neg_logp, q)

    U, g = potential(ts.z)
    qn, Un, gn, acc, accept, (q1, p1) = thmc._hmc_transition(
        ts.z, U, g, p0, torch.as_tensor(log_u),
        torch.as_tensor(eps, dtype=torch.float64), mass, L, potential)
    by_uuid(qn, qn_j, sides=sides[name])
    by_uuid(q1, q1_j, sides=sides[name])
    by_uuid(p1, p1_j, sides=sides[name])
    close(acc, acc_j)
    assert 0 < int(accept.sum()) or name != "blr"
    U_ref, g_ref = potential(qn)
    close(Un, U_ref)
    by_uuid(gn, {u: v.numpy() for u, v in g_ref.items()})


def test_hmc_transition_rejects_a_nan_trajectory(sides):
    """A NaN potential at the endpoint counts as a rejection (hmc.py:301):
    accept_prob 0, the state and its carried potential kept."""
    _, ts = sides["blr"]
    calls = {"n": 0}

    def potential(q):
        calls["n"] += 1
        U, g = thmc.value_and_grad(ts.neg_logp, q)
        return U * float("nan"), g

    U, g = thmc.value_and_grad(ts.neg_logp, ts.z)
    _, _, p0, _, log_u = explicit_draws(sides["blr"], 4)
    qn, Un, _, acc, accept, _ = thmc._hmc_transition(
        ts.z, U, g, p0, torch.as_tensor(log_u),
        torch.as_tensor(0.01, dtype=torch.float64), None, 3, potential)
    assert calls["n"] == 3 and not accept.any()
    assert torch.equal(acc, torch.zeros(3, dtype=torch.float64))
    assert torch.equal(qn[ts.uuids[0]], ts.z[ts.uuids[0]])
    assert torch.equal(Un, U)


def jax_dual_averaging(carry, mean_accept, target, mu):
    """mxfusion_tpu/inference/hmc.py:316-334 (warmup_body's update)."""
    log_eps, log_eps_bar, h_bar, t = carry
    gamma, t0, kappa = 0.05, 10.0, 0.75
    t = t + 1.0
    h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + \
        (target - mean_accept) / (t + t0)
    log_eps = mu - jnp.sqrt(t) / gamma * h_bar
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return log_eps, log_eps_bar, h_bar, t


def test_dual_averaging_matches_jax():
    eps0 = 0.1
    ref = tuple(jnp.asarray(v, jnp.float64) for v in
                (np.log(eps0), np.log(eps0), 0.0, 0.0))
    out = thmc._dual_averaging_start(torch.tensor(eps0, dtype=torch.float64))
    mu = np.log(10.0 * eps0)
    for a in np.random.default_rng(5).uniform(0.0, 1.0, 12):
        ref = jax_dual_averaging(ref, jnp.asarray(a), 0.8, jnp.asarray(mu))
        out = thmc._dual_averaging(out, torch.tensor(a), 0.8,
                                   torch.tensor(mu))
        for o, r in zip(out, ref):
            close(o, r)


def jax_chees_gradient(q, q1, v1, accept_prob, traj_frac, uuids):
    """mxfusion_tpu/inference/chees.py:152-173."""
    C = accept_prob.shape[0]

    def centered(z):
        flat = jnp.concatenate([z[u].reshape(C, -1) for u in uuids], axis=1)
        return flat - jnp.mean(flat, axis=0, keepdims=True)
    cq, cq1 = centered(q), centered(q1)
    v = jnp.concatenate([v1[u].reshape(C, -1) for u in uuids], axis=1)
    jump = jnp.sum(cq1 ** 2, axis=1) - jnp.sum(cq ** 2, axis=1)
    term = jump * jnp.sum(cq1 * v, axis=1) * traj_frac
    w = accept_prob / (jnp.sum(accept_prob) + 1e-12)
    return jnp.sum(w * term)


def jax_adam_on_log_T(log_T, mT, vT, g, it, eps, max_leapfrog):
    """mxfusion_tpu/inference/chees.py:190-203."""
    b1, b2, adam_lr = 0.9, 0.95, 0.025
    mT = b1 * mT + (1.0 - b1) * g
    vT = b2 * vT + (1.0 - b2) * g ** 2
    mh = mT / (1.0 - b1 ** it)
    vh = vT / (1.0 - b2 ** it)
    log_T = log_T + adam_lr * mh / (jnp.sqrt(vh) + 1e-8)
    return jnp.clip(log_T, jnp.log(eps), jnp.log(eps * max_leapfrog)), mT, vT


@pytest.mark.parametrize("name", ["blr", "gp_noise"])
def test_chees_step_matches_jax(sides, name):
    """One jittered proposal at the trip count of chees.py:135, then the
    acceptance-weighted ChEES gradient and Adam's ascent on log T
    (chees.py:152-203), over three warmup iterations."""
    js, ts = sides[name]
    rng = np.random.default_rng(6)
    eps, T = 0.05, 0.4
    log_T = (jnp.log(T), torch.tensor(np.log(T)))
    mT = (jnp.zeros(()), torch.zeros((), dtype=torch.float64))
    vT = (jnp.zeros(()), torch.zeros((), dtype=torch.float64))
    ones = {u: jnp.ones(np.shape(v)[1:]) for u, v in js.z.items()}
    for it in (1.0, 2.0, 3.0):
        p0_j, _, p0, _, log_u = explicit_draws(sides[name], 7 + int(it))
        u = rng.uniform()
        T_now = float(np.exp(np.asarray(log_T[0])))
        n_j = int(np.clip(np.ceil(u * T_now / eps), 1, 64))
        u_t = torch.tensor(u, dtype=torch.float64)
        n_t = tchees._trip_count(u_t, torch.exp(log_T[1]),
                                 torch.tensor(eps, dtype=torch.float64), 64)
        assert n_t == n_j > 0
        _, acc_j, q1_j, v1_j = jax_hmc_transition(
            js.neg_logp, js.z, p0_j, jnp.asarray(log_u), eps, ones, n_j)
        g_j = jax_chees_gradient(js.z, q1_j, v1_j, acc_j, u, js.uuids) * \
            jnp.exp(log_T[0])
        lj = jax_adam_on_log_T(log_T[0], mT[0], vT[0], g_j, it, eps, 64)

        def potential(q):
            return thmc.value_and_grad(ts.neg_logp, q)
        U, g = potential(ts.z)
        _, _, _, acc, _, (q1, v1) = thmc._hmc_transition(
            ts.z, U, g, p0, torch.as_tensor(log_u),
            torch.tensor(eps, dtype=torch.float64), None, n_t, potential)
        close(acc, acc_j)
        g_t = tchees._chees_gradient(ts.z, q1, v1, acc, u_t, ts.uuids) * \
            torch.exp(log_T[1])
        close(g_t, g_j)
        lt = tchees._adam_ascent(log_T[1], mT[1], vT[1], g_t,
                                 torch.tensor(it, dtype=torch.float64),
                                 torch.tensor(eps, dtype=torch.float64), 64)
        for o, r in zip(lt, lj):
            close(o, r)
        log_T, mT, vT = zip(lj, lt)


def test_chees_gradient_ignores_a_diverged_chain():
    """The port's one deliberate difference (chees.py's docstring): a
    proposal accepted with probability 0 whose q⁺ overflowed makes
    JAX's gradient NaN (and so T, from then on); the port counts that
    chain as no jump and keeps the gradient of the others."""
    rng = np.random.default_rng(8)
    q = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    q1 = {"w": q["w"] + 0.1 * rng.standard_normal((4, 3)).astype(np.float32)}
    v1 = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    q1["w"][2] = 3e37          # overflows when squared in float32
    v1["w"][2] = np.inf
    acc = np.array([0.9, 0.5, 0.0, 0.7], np.float32)
    ref = jax_chees_gradient({"w": jnp.asarray(q["w"])},
                             {"w": jnp.asarray(q1["w"])},
                             {"w": jnp.asarray(v1["w"])}, jnp.asarray(acc),
                             0.5, ["w"])
    assert np.isnan(np.asarray(ref))
    out = tchees._chees_gradient(to_torch(q), to_torch(q1), to_torch(v1),
                                 torch.as_tensor(acc), torch.tensor(0.5),
                                 ["w"])
    # the same as JAX's on the chain held at q with velocity 0
    q1["w"][2], v1["w"][2] = q["w"][2], 0.0
    same = jax_chees_gradient({"w": jnp.asarray(q["w"])},
                              {"w": jnp.asarray(q1["w"])},
                              {"w": jnp.asarray(v1["w"])}, jnp.asarray(acc),
                              0.5, ["w"])
    assert np.isfinite(float(out))
    close(out, same, rtol=1e-6)


# ---------------------------------------------------------------------
# whole chains (the port's alone): the JAX tests' oracles
# ---------------------------------------------------------------------

def test_hmc_conjugate_gaussian_mean():
    """tests/inference/test_hmc.py:16-44."""
    N, s2, tau2 = 50, 4.0, 100.0
    m, obs, data = conjugate_gaussian(T, N, s2, tau2)
    y = data["y"]
    infr = HMCInference(HMCAlgorithm(model=m, observed=obs, num_samples=300,
                                     num_warmup=200, num_chains=4,
                                     num_leapfrog=8))
    samples = infr.run(y=y, generator=gen(0))
    post_var = 1.0 / (N / s2 + 1.0 / tau2)
    post_mean = post_var * y.sum() / s2
    draws = samples[m.mu.uuid].numpy().reshape(-1)
    se = np.sqrt(post_var / max(1.0, len(draws) / 10))
    assert abs(draws.mean() - post_mean) < 5 * se + 0.05
    assert np.isclose(draws.var(), post_var, rtol=0.35)
    acc = infr.diagnostics["accept_rate"]
    assert np.all(acc > 0.4) and np.all(acc <= 1.0)
    assert infr.diagnostics["r_hat_max"] < 1.1


def _posterior_moments(name, data):
    if name == "gamma_exponential":
        a, b = 2 + data["y"].shape[0], 2 + data["y"].sum()
        return a / b, a / b ** 2
    if name == "beta_bernoulli":
        k = data["y"].sum()
        a, b = 2 + k, 2 + data["y"].shape[0] - k
        return a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))
    alpha = 2.0 + data["y"].sum(0)
    a0 = alpha.sum()
    return alpha / a0, alpha * (a0 - alpha) / (a0 ** 2 * (a0 + 1))


@pytest.mark.parametrize("name,atol,rtol", [
    ("gamma_exponential", None, 0.05), ("beta_bernoulli", 0.02, None),
    ("dirichlet_categorical", 0.02, None)])
def test_hmc_constrained_latent_conjugates(name, atol, rtol):
    """tests/inference/test_mcmc_over_modules.py:38-149: positive, unit
    interval and simplex latents through the support bijectors, at the
    JAX tests' tolerances on 4 x 300 draws (their 1000 and 800)."""
    m, obs, data = MODELS[name](T)
    infr = HMCInference(HMCAlgorithm(model=m, observed=obs, num_samples=300,
                                     num_warmup=200, num_chains=4,
                                     num_leapfrog=8))
    (x,) = infr.run(generator=gen(2), **data).values()
    x = x.numpy().reshape(-1 if name != "dirichlet_categorical" else
                          (-1, 3))
    mean, var = _posterior_moments(name, data)
    if name == "gamma_exponential":
        assert np.all(x > 0)
    elif name == "beta_bernoulli":
        assert np.all((x > 0) & (x < 1))
    else:
        np.testing.assert_allclose(x.sum(-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(x.mean(0), mean, rtol=rtol or 0,
                               atol=atol or 0)
    np.testing.assert_allclose(x.var(0), var, rtol=0.35)


def test_hmc_over_gp_module_hyperparameter():
    """tests/inference/test_mcmc_over_modules.py:36-51 and :215-225: the
    noise variance of GPRegression; the trainable kernel parameters
    collect no gradient and the draws carry no graph."""
    m, obs, data = gp_noise(T)
    infr = HMCInference(HMCAlgorithm(model=m, observed=obs, num_samples=150,
                                     num_chains=2, num_warmup=150,
                                     num_leapfrog=8))
    (nv,) = infr.run(generator=gen(0), **data).values()
    assert tuple(nv.shape) == (150, 2, 1) and not nv.requires_grad
    assert bool((nv > 0).all())
    assert 0.005 < float(nv.mean()) < 0.05, float(nv.mean())
    assert infr.diagnostics["accept_rate"].min() > 0.5
    assert infr.diagnostics["r_hat_max"] < 1.2
    assert all(p.grad is None
               for p in infr.params.trainable_params().values())


def test_chees_adapts_trajectory_to_correlated_posterior():
    """tests/inference/test_chees.py:49-86 on 8 x 300 draws (its 500)."""
    m, obs, data = blr(T, N=80, correlated=True)
    X, y = data["X"], data["y"]
    infr = ChEESHMCInference(ChEESHMCAlgorithm(
        model=m, observed=obs, num_samples=300, num_warmup=300,
        num_chains=8, trajectory_length=0.05, step_size=0.05))
    samples = infr.run(generator=gen(1), **data)
    Sigma = np.linalg.inv(X.T @ X / 0.25 + np.eye(3))
    mu = Sigma @ X.T @ y[:, 0] / 0.25
    draws = samples[m.w.uuid].numpy().reshape(-1, 3)
    np.testing.assert_allclose(draws.mean(0), mu, atol=0.06)
    np.testing.assert_allclose(draws.var(0), np.diag(Sigma), rtol=0.5,
                               atol=5e-4)
    d = infr.diagnostics
    assert d["mean_leapfrog_steps"] > 1.5, d
    assert float(d["step_size"]) < float(d["trajectory_length"])
    assert np.all(d["accept_rate"] > 0.3)


@pytest.mark.parametrize("sampler", ["hmc", "chees"])
def test_shapes_targets_determinism_and_predictive(sampler):
    """tests/inference/test_hmc.py:75-98, test_chees.py:89-129 and
    test_hmc.py:134-157: target variables, one generator seed giving the
    same chain, and posterior-predictive draws of every chain."""
    N = 20
    m, obs, data = conjugate_gaussian(T, N=N, s2=1.0, tau2=10.0)

    def run():
        if sampler == "hmc":
            infr = HMCInference(HMCAlgorithm(
                model=m, observed=obs, num_samples=30, num_warmup=20,
                num_chains=2, num_leapfrog=5, target_variables=[m.mu]))
        else:
            infr = ChEESHMCInference(ChEESHMCAlgorithm(
                model=m, observed=obs, num_samples=30, num_warmup=20,
                num_chains=2, target_variables=[m.mu]))
        return infr, infr.run(generator=gen(3), **data)

    infr, s1 = run()
    _, s2 = run()
    assert set(s1) == {m.mu.uuid}
    assert tuple(s1[m.mu.uuid].shape) == (30, 2, 1)
    assert torch.equal(s1[m.mu.uuid], s2[m.mu.uuid])
    pred = infr.sample_predictive(generator=gen(4))
    yrep = pred[m.y.uuid]
    assert tuple(yrep.shape) == (60, N, 1)
    assert abs(float(yrep.mean()) - data["y"].mean()) < 0.6
    again = infr.sample_predictive(generator=gen(4))
    assert torch.equal(again[m.y.uuid], yrep)


def test_posterior_predictive_moments():
    """tests/inference/test_hmc.py:134-157: var = s2 + post_var."""
    N, s2, tau2 = 50, 4.0, 100.0
    m, obs, data = conjugate_gaussian(T, N, s2, tau2)
    infr = HMCInference(HMCAlgorithm(model=m, observed=obs, num_samples=250,
                                     num_warmup=150, num_chains=4,
                                     num_leapfrog=8))
    infr.run(generator=gen(0), **data)
    yrep = infr.sample_predictive(generator=gen(1))[m.y.uuid].numpy()
    assert yrep.shape == (1000, N, 1)
    post_var = 1.0 / (N / s2 + 1.0 / tau2)
    post_mean = post_var * data["y"].sum() / s2
    flat = yrep.reshape(yrep.shape[0], -1)
    assert abs(flat.mean() - post_mean) < 0.15
    assert np.isclose(flat.var(), s2 + post_var, rtol=0.15)


def test_error_paths():
    m, obs, data = conjugate_gaussian(T)
    with pytest.raises(InferenceError):
        HMCInference(HMCAlgorithm(model=m, observed=obs)).sample_predictive()
    with pytest.raises(InferenceError):
        # every random variable observed: nothing to sample
        HMCInference(HMCAlgorithm(model=m, observed=[m.mu, m.y])).run(
            mu=np.zeros(1), generator=gen(), **data)
    with pytest.raises(InferenceError):
        ChEESHMCInference(ChEESHMCAlgorithm(
            model=m, observed=[m.mu, m.y])).run(mu=np.zeros(1),
                                                generator=gen(), **data)
