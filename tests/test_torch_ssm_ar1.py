"""``LinearGaussianSSM`` and ``GaussianAR1`` against the JAX package.

Both packages build the same model from the same float64 numpy inputs:
the executors' losses (the Kalman marginal likelihood through the
sequential, the parallel and the masked filter) agree at rtol 1e-10 and
their gradients at 1e-9; the port reproduces ``golden_ssm_map.npz``
(``tests/goldens/configs.py:236-265``) at 1e-8 without JAX, and the MAP
fit's losses and ``metrics_callback`` records of JAX's
``BatchInferenceLoop`` at 1e-10 under ``steps_per_call`` 1 and 2; a JAX
zip and a JAX state load into the port and give the same loss. AR1's
log-density and its draws on the same fixed normals agree at 1e-12, and
the stochastic-volatility potential (``examples/stochastic_volatility.py``'s
model) and its gradient at 1e-10."""
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import mxfusion_tpu as mj
from mxfusion_tpu import inference as jinf
from mxfusion_tpu.components import distributions as jdist
from mxfusion_tpu.components.distributions.random_gen import \
    FixedRandomGenerator as JFixed
from mxfusion_tpu.components.functions import operators as jops
from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive
from mxfusion_tpu.inference import hmc as jhmc
from mxfusion_tpu.inference import inference_alg as jalg

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch import inference as tinf
from mxfusion_tpu_torch.components import distributions as tdist
from mxfusion_tpu_torch.components.distributions.random_gen import \
    FixedRandomGenerator
from mxfusion_tpu_torch.components.functions import operators as tops
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import hmc as thmc
from mxfusion_tpu_torch.inference import inference_alg as talg
from mxfusion_tpu_torch.util.carryover import load_state, name_paths
from tests.test_torch_hmc_chees import J as HMC_J, T as HMC_T, one_side
from tests.test_torch_kalman import close, lgssm_small, mask_for
from tests.test_torch_meanfield import _on_the_cpu_in_float64  # noqa: F401
from tests.test_torch_svgp_classification import jax_f64

RTOL = 1e-10
GOLDEN = Path(__file__).parent / "goldens" / "golden_ssm_map.npz"

J = SimpleNamespace(pkg=mj, dist=jdist, ops=jops, inf=jinf, alg=jalg,
                    Positive=JPositive, Fixed=JFixed, hmc=jhmc)
T = SimpleNamespace(pkg=mt, dist=tdist, ops=tops, inf=tinf, alg=talg,
                    Positive=PositiveTransformation,
                    Fixed=FixedRandomGenerator, hmc=thmc)


@pytest.fixture(autouse=True, scope="module")
def _jax_in_float64():
    with jax_f64():
        yield


def ssm(P, y, A_init, parallel=False, mask=None, noise_params=False):
    """test_ssm.py's model: A a parameter, the rest constants (or, with
    ``noise_params``, the noise variances q and r positive parameters)."""
    _, A, H, Q, R, m0, P0 = lgssm_small()
    V = P.pkg.Variable
    m = P.pkg.Model()
    m.A = V(shape=(2, 2), initial_value=A_init)
    if noise_params:
        m.q = V(shape=(1,), transformation=P.Positive(), initial_value=0.08)
        m.r = V(shape=(1,), transformation=P.Positive(), initial_value=0.2)
        trans = P.ops.multiply(P.ops.broadcast_to(m.q, (2, 2)),
                               V(value=np.eye(2)))
        obs = P.ops.multiply(P.ops.broadcast_to(m.r, (1, 1)),
                             V(value=np.eye(1)))
    else:
        trans, obs = V(value=Q), V(value=R)
    m.y = P.dist.LinearGaussianSSM.define_variable(
        A=m.A, H=V(value=H), trans_cov=trans, obs_cov=obs,
        initial_mean=V(value=m0), initial_cov=V(value=P0),
        observation_mask=mask, parallel_filter=parallel,
        shape=y.shape, dtype="float64")
    return m


def map_inference(P, m, **kw):
    kw = dict(kw, device="cpu") if P is T else kw
    return P.inf.GradBasedInference(P.inf.MAP(model=m, observed=[m.y]),
                                    dtype="float64", **kw)


def loss_fn(P, infr, y):
    """The executor's loss as a function of the trainable parameters."""
    ex = P.alg.create_executor(infr._algorithm, infr.params)
    fixed = infr.params.fixed_params()
    if P is J:
        return lambda tr: ex(tr, fixed, [y], jax.random.PRNGKey(0))[0]
    return lambda tr: ex(tr, fixed, [torch.as_tensor(y)],
                         torch.Generator().manual_seed(0))[0]


def port_loss_and_grad(tinfr, y):
    tr = {k: v.detach().clone().requires_grad_(True)
          for k, v in tinfr.params.trainable_params().items()}
    loss = loss_fn(T, tinfr, y)(tr)
    return loss, dict(zip(tr, torch.autograd.grad(loss, list(tr.values()))))


def by_name(m, d):
    return {m[u].name: v for u, v in d.items()}


# ---------------------------------------------------------------------
# LinearGaussianSSM
# ---------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["sequential", "parallel", "masked"])
def test_executor_loss_matches_jax(variant):
    y = lgssm_small(2)[0]
    A_init = np.array([[0.8, 0.1], [0.05, 0.6]])
    kw = {"parallel": variant == "parallel",
          "mask": mask_for(80) if variant == "masked" else None}
    jm, tm = ssm(J, y, A_init, **kw), ssm(T, y, A_init, **kw)
    ji, ti = map_inference(J, jm), map_inference(T, tm)
    ji.initialize(y=y)
    ti.initialize(y=y)
    f = loss_fn(J, ji, y)
    tr = ji.params.trainable_params()
    if variant == "parallel":
        # one compile of the associative scan, value and gradient together
        ref, ref_g = jax.jit(jax.value_and_grad(f))(tr)
    else:
        ref, ref_g = f(tr), jax.grad(f)(tr)
    loss, grads = port_loss_and_grad(ti, y)
    close(loss, ref)
    g, rg = by_name(tm, grads), by_name(jm, ref_g)
    assert sorted(g) == sorted(rg) == ["A"]
    close(g["A"], rg["A"], rtol=1e-9)


def golden_ssm_data():
    """tests/goldens/configs.py:236-265's data (T = 60, seed 41)."""
    _, A, H, Q, R, _, _ = lgssm_small()
    rng = np.random.default_rng(41)
    x = np.zeros((60, 2))
    x[0] = rng.standard_normal(2)
    for t in range(1, 60):
        x[t] = A @ x[t - 1] + rng.multivariate_normal(np.zeros(2), Q)
    return x @ H.T + rng.multivariate_normal(np.zeros(1), R, size=60)


def test_map_trajectory_matches_golden():
    """The port alone reproduces the JAX package's 50 recorded losses."""
    y = golden_ssm_data()
    m = ssm(T, y, np.eye(2) * 0.5)
    losses = []
    map_inference(T, m).run(y=y, max_iter=50, learning_rate=0.05,
                            callback=lambda i, l: losses.append(float(l)))
    np.testing.assert_allclose(losses, np.load(GOLDEN)["losses"],
                               rtol=1e-8)


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_batch_loop_records_match_jax(steps_per_call):
    """The SSM MAP fit through ``BatchInferenceLoop(steps_per_call=k,
    metrics_callback=...)``: the callback's losses and the metrics'
    ``loss`` and ``grad_norm`` (at every k-th step, the chunk's last)
    equal JAX's at 1e-10 (``batch_loop.py:48-64, 109-168`` there)."""
    y = golden_ssm_data()
    out = {}
    for P in (J, T):
        rec = {"cb": [], "metrics": []}
        loop = P.inf.BatchInferenceLoop(
            steps_per_call=steps_per_call,
            metrics_callback=lambda i, m, rec=rec: rec["metrics"].append(
                (i, m["loss"], m["grad_norm"], m["step_time_s"])))
        m = ssm(P, y, np.eye(2) * 0.5)
        final = map_inference(P, m, grad_loop=loop).run(
            y=y, max_iter=6, learning_rate=0.05,
            callback=lambda i, l, rec=rec: rec["cb"].append((i, float(l))))
        rec["final"] = float(np.asarray(final))
        out[P is T] = rec
    ref, got = out[False], out[True]
    steps = list(range(steps_per_call - 1, 6, steps_per_call))
    for rec in (ref, got):
        assert [i for i, _ in rec["cb"]] == steps
        assert [r[0] for r in rec["metrics"]] == steps
        assert all(r[3] > 0.0 for r in rec["metrics"])
    close([l for _, l in got["cb"]], [l for _, l in ref["cb"]])
    close([r[1:3] for r in got["metrics"]], [r[1:3] for r in ref["metrics"]])
    close(got["final"], ref["final"])


def test_jax_state_and_zip_load_in_the_port(tmp_path):
    """A JAX fit of A and the two noise variances, saved as a zip and
    carried as a state: the port's executor gives JAX's loss both ways."""
    y = lgssm_small(4)[0]
    A_init = np.eye(2) * 0.5
    jm = ssm(J, y, A_init, noise_params=True)
    ji = map_inference(J, jm)
    ji.run(y=y, max_iter=5, learning_rate=0.05)
    path = str(tmp_path / "ssm.zip")
    ji.save(path)
    ref = loss_fn(J, ji, y)(ji.params.trainable_params())
    for how in ("zip", "state"):
        tm = ssm(T, y, A_init, noise_params=True)
        ti = map_inference(T, tm)
        ti.initialize(y=y)
        if how == "zip":
            ti.load(path)
        else:
            load_state(ti.params, {k: np.asarray(v) for k, v in
                                   ji.params.param_dict.items()},
                       ti.graphs, source_graphs=ji.graphs)
        for name in ("A", "q", "r"):
            close(ti.params.param_dict[getattr(tm, name).uuid],
                  ji.params.param_dict[getattr(jm, name).uuid])
        close(loss_fn(T, ti, y)(ti.params.trainable_params()), ref)


def test_forward_sampling_statistics():
    """test_forward_sampling_statistics on the port: 300 simulated
    trajectories have the model's stationary variance late in the
    series, and the mask does not change the draws."""
    _, A, H, Q, R, _, P0 = lgssm_small()
    y = np.zeros((80, 1))
    for mask in (None, mask_for(80)):
        m = ssm(T, y, A, mask=mask)
        alg = T.inf.ForwardSamplingAlgorithm(model=m, observed=[],
                                             num_samples=300,
                                             target_variables=[m.y.uuid])
        s = T.inf.Inference(alg, dtype="float64", device="cpu").run(
            generator=torch.Generator().manual_seed(0))[0].numpy()
        assert s.shape == (300, 80, 1)
        if mask is None:
            first = s
        else:
            np.testing.assert_array_equal(s, first)
    P = P0.copy()
    for _ in range(200):
        P = A @ P @ A.T + Q
    late = first[:, 40:, 0]
    np.testing.assert_allclose(late.var(), (H @ P @ H.T + R)[0, 0],
                               rtol=0.15)
    np.testing.assert_allclose(late.mean(), 0.0, atol=0.1)


def test_mask_needs_the_sequential_filter():
    for P in (J, T):
        with pytest.raises(ValueError, match="sequential filter"):
            ssm(P, np.zeros((80, 1)), np.eye(2), parallel=True,
                mask=mask_for(80))


# ---------------------------------------------------------------------
# GaussianAR1
# ---------------------------------------------------------------------

AR1_NAMES = ("phi", "noise_var", "init_mean", "init_var")


def ar1_env(P, values, x=None, T_=15, rand_gen=None):
    """A bare GaussianAR1 factor over a (T_,) path and its env (each
    parameter with the sample axis, as the executor builds it)."""
    inputs = {n: P.pkg.Variable() for n in AR1_NAMES}
    dist = P.dist.GaussianAR1(dtype="float64", rand_gen=rand_gen, **inputs)
    dist._generate_outputs(shape=(T_,))
    arr = (lambda a: np.asarray(a)) if P is J else torch.as_tensor
    env = {inputs[n].uuid: arr(np.asarray(values[n], dtype=np.float64)[None])
           for n in AR1_NAMES}
    if x is not None:
        env[dist.random_variable.uuid] = arr(x)
    return dist, env


AR1_VALUES = {"phi": [0.8], "noise_var": [0.3], "init_mean": [-0.5],
              "init_var": [1.2]}


def test_ar1_log_pdf_matches_jax():
    x = np.random.default_rng(0).standard_normal((4, 15))
    jd, jenv = ar1_env(J, AR1_VALUES, x)
    td, tenv = ar1_env(T, AR1_VALUES, x)
    out = td.log_pdf(tenv)
    assert tuple(out.shape) == (4, 15)
    close(out, jd.log_pdf(jenv), rtol=1e-12)


def test_ar1_fixed_draws_match_jax():
    """The time recursion on the same normals (``FixedRandomGenerator``
    gives both packages one buffer)."""
    eps = np.random.default_rng(1).standard_normal(6 * 15)
    jd, jenv = ar1_env(J, AR1_VALUES, rand_gen=JFixed(eps))
    td, tenv = ar1_env(T, AR1_VALUES, rand_gen=FixedRandomGenerator(eps))
    ref = jd.draw_samples(jenv, jax.random.PRNGKey(0), num_samples=6)
    out = td.draw_samples(tenv, torch.Generator(), num_samples=6)
    assert tuple(out.shape) == (6, 15)
    close(out, ref, rtol=1e-12)


@pytest.mark.parametrize("call", ["log_pdf", "draw_samples"])
def test_ar1_rejects_time_shaped_parameters(call):
    values = dict(AR1_VALUES, phi=np.full(10, 0.9))
    td, tenv = ar1_env(T, values, x=np.zeros((2, 10)), T_=10)
    with pytest.raises(ValueError, match="time-constant"):
        if call == "log_pdf":
            td.log_pdf(tenv)
        else:
            td.draw_samples(tenv, torch.Generator(), num_samples=2)


def ar1_observed(P, x, named):
    """An AR(1) path observed, its phi and noise variance parameters
    (named, or unnamed and so carried as ``p(x).phi``)."""
    m = P.pkg.Model()
    phi = P.pkg.Variable(shape=(1,), initial_value=0.5)
    noise_var = P.pkg.Variable(shape=(1,), transformation=P.Positive(),
                               initial_value=0.5)
    if named:
        m.phi, m.noise_var = phi, noise_var
    m.x = P.dist.GaussianAR1.define_variable(
        phi=phi, noise_var=noise_var, init_mean=P.pkg.Variable(value=0.0),
        init_var=P.pkg.Variable(value=1.0), shape=x.shape)
    return m


@pytest.mark.parametrize("named", [True, False], ids=["named", "unnamed"])
def test_ar1_state_carries_over(named):
    """JAX's MAP fit of phi and the noise variance, carried by name path,
    gives the port JAX's loss and gradient."""
    rng = np.random.default_rng(5)
    x = np.zeros(40)
    for t in range(1, 40):
        x[t] = 0.9 * x[t - 1] + 0.4 * rng.standard_normal()
    jm, tm = ar1_observed(J, x, named), ar1_observed(T, x, named)
    ji = J.inf.GradBasedInference(J.inf.MAP(model=jm, observed=[jm.x]),
                                  dtype="float64")
    ji.run(x=x, max_iter=5, learning_rate=0.1)
    ti = T.inf.GradBasedInference(T.inf.MAP(model=tm, observed=[tm.x]),
                                  dtype="float64", device="cpu")
    ti.initialize(x=x)
    load_state(ti.params, {k: np.asarray(v) for k, v in
                           ji.params.param_dict.items()},
               ti.graphs, source_graphs=ji.graphs)
    ex_j = J.alg.create_executor(ji._algorithm, ji.params)
    ex_t = T.alg.create_executor(ti._algorithm, ti.params)
    fj = ji.params.fixed_params()

    def f(tr):
        return ex_j(tr, fj, [x], jax.random.PRNGKey(0))[0]

    trj = ji.params.trainable_params()
    tr = {k: v.detach().clone().requires_grad_(True)
          for k, v in ti.params.trainable_params().items()}
    loss = ex_t(tr, ti.params.fixed_params(), [torch.as_tensor(x)],
                torch.Generator())[0]
    grads = torch.autograd.grad(loss, list(tr.values()))
    close(loss, f(trj))
    pj, pt = name_paths(ji.graphs), name_paths(ti.graphs)
    g = {pt[u]: v for u, v in zip(tr, grads)}
    rg = {pj[u]: v for u, v in jax.grad(f)(trj).items()}
    want = ["noise_var", "phi"] if named else ["p(x).noise_var",
                                              "p(x).phi"]
    assert sorted(g) == sorted(rg) == want
    for k in g:
        close(g[k], rg[k])


def stochastic_volatility(P, T_=40):
    """examples/stochastic_volatility.py's model and data at T = 40."""
    rng = np.random.default_rng(0)
    phi, sig = 0.95, 0.25
    x = np.zeros(T_)
    x[0] = -1.0 + 0.5 * rng.standard_normal()
    for t in range(1, T_):
        x[t] = phi * x[t - 1] + sig * rng.standard_normal()
    y = np.exp(x / 2) * rng.standard_normal(T_)
    m = P.pkg.Model()
    m.x = P.dist.GaussianAR1.define_variable(
        phi=P.pkg.Variable(value=phi), noise_var=P.pkg.Variable(
            value=sig ** 2),
        init_mean=P.pkg.Variable(value=-1.0),
        init_var=P.pkg.Variable(value=1.0), shape=(T_,))
    m.y = P.dist.Normal.define_variable(
        mean=P.pkg.Variable(value=np.zeros(T_)), variance=P.ops.exp(m.x),
        shape=(T_,))
    return m, [m.y], {"y": y}


def test_stochastic_volatility_potential_matches_jax():
    """HMC's potential over the latent log-volatility path and its
    gradient, three chains from the same fixed prior draws."""
    js = one_side(HMC_J, stochastic_volatility, 3)
    ts = one_side(HMC_T, stochastic_volatility, 3)
    close(ts.q[ts.m.x.uuid], js.q[js.m.x.uuid])
    U_j = js.neg_logp(js.z)
    g_j = jax.grad(lambda q: js.neg_logp(q).sum())(js.z)
    U_t, g_t = thmc.value_and_grad(ts.neg_logp, ts.z)
    assert tuple(U_t.shape) == (3,)
    close(U_t, U_j)
    close(g_t[ts.m.x.uuid], g_j[js.m.x.uuid])
