"""SVGP binary classification against the JAX package: the quadrature
bound and its gradient in every parameter, the predictions, forward
draws, a JAX state carried across by name path, and the golden
``golden_svgp_classification.npz`` trajectory. float64 throughout.

Both packages start from one state: the JAX package initializes it, the
test moves q(U) off its initial value with seeded numpy draws, and
``util.carryover.load_state`` moves it into the port's store by name
path. The helpers here (``pair``, ``loss_and_grads``, ``serve``) are
shared with ``test_torch_svgp_counts.py`` and
``test_torch_svgp_multiclass.py``.
"""
import contextlib
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import mxfusion_tpu as mj
import mxfusion_tpu.modules as jmodules
from mxfusion_tpu import inference as jinference
from mxfusion_tpu.common import config as jconfig
from mxfusion_tpu.components.distributions import \
    FixedRandomGenerator as JFixed
from mxfusion_tpu.components.distributions.gp.kernels import RBF as JRBF
from mxfusion_tpu.modules.gp_modules import svgp_classification as jsc

import mxfusion_tpu_torch as mt
import mxfusion_tpu_torch.modules as tmodules
from mxfusion_tpu_torch import inference as tinference
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.distributions import FixedRandomGenerator
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules.gp_modules import svgp_classification as tsc
from mxfusion_tpu_torch.util.carryover import load_state, name_paths


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port runs on the card unless the CPU is asked for: these tests
    ask for it, and put the previous default back afterwards."""
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


RTOL = 1e-10
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "goldens", "golden_svgp_classification.npz")
J = SimpleNamespace(pkg=mj, rbf=JRBF, modules=jmodules, inf=jinference,
                    Fixed=JFixed)
T = SimpleNamespace(pkg=mt, rbf=RBF, modules=tmodules, inf=tinference,
                    Fixed=FixedRandomGenerator)


@contextlib.contextmanager
def jax_f64():
    old = jconfig.get_default_dtype()
    jconfig.set_default_dtype("float64")
    try:
        yield
    finally:
        jconfig.set_default_dtype(old)


def build(P, module, Z0, columns=1, mean=None, dispersion=None,
          noise=None, variance=1.3, lengthscale=0.9, **kw):
    """``module`` (a class name shared by both packages) over X, with a
    constant ``mean`` or ``dispersion`` when given, and the fixed
    ``noise`` as the module's random generator."""
    D = Z0.shape[1]
    m = P.pkg.Model()
    m.n = P.pkg.Variable()
    m.X = P.pkg.Variable(shape=(m.n, D))
    if mean is not None:
        m.mean = P.pkg.Variable(value=mean)
        kw["mean"] = m.mean
    if dispersion is not None:
        m.dispersion = P.pkg.Variable(value=dispersion)
        kw["dispersion"] = m.dispersion
    if noise is not None:
        kw["rand_gen"] = P.Fixed(noise)
    m.Y = getattr(P.modules, module).define_variable(
        X=m.X, kernel=P.rbf(input_dim=D, variance=variance,
                            lengthscale=lengthscale, dtype="float64"),
        shape=(m.n, columns),
        inducing_inputs=P.pkg.Variable(shape=Z0.shape, initial_value=Z0),
        dtype="float64", **kw)
    return m


def by_path(graphs, store):
    paths = name_paths(graphs)
    return {paths[k]: np.asarray(v.detach() if torch.is_tensor(v) else v)
            for k, v in store.items()}


def moved_state(jinf, seed):
    """The JAX store with q(U) moved off its initial value: a mean of
    scale 0.5, a covariance factor 0.2·noise + I and a diagonal around
    1e-2, by name path."""
    rng = np.random.default_rng(seed)
    state = by_path(jinf.graphs, jinf.params.param_dict)
    M, C = state["Y.qU_mean"].shape
    state["Y.qU_mean"] = rng.standard_normal((M, C)) * 0.5
    state["Y.qU_cov_W"] = rng.standard_normal((M, M)) * 0.2 + np.eye(M)
    state["Y.qU_cov_diag"] = rng.uniform(-5.0, -3.0, M)
    return state


def pair(module, X, Y, Z0, seed=0, key=0, state=None, jloop=None,
         loop=None, **kw):
    """The JAX MAP inference and the port's, both at one state: the JAX
    package's initial state for ``key`` with q(U) moved by ``seed``
    (``state=None``), or ``state`` itself (by name path) when given."""
    with jax_f64():
        jm = build(J, module, Z0, **kw)
        jinf = J.inf.GradBasedInference(
            J.inf.MAP(model=jm, observed=[jm.X, jm.Y]), grad_loop=jloop,
            dtype="float64")
        jinf.initialize(X=X, Y=Y, key=jax.random.PRNGKey(key))
        if state is None:
            state = moved_state(jinf, seed)
        if state:
            jpaths = {p: u for u, p in name_paths(jinf.graphs).items()}
            jinf.params.update_params(
                {jpaths[p]: jax.numpy.asarray(v) for p, v in state.items()})
    tm = build(T, module, Z0, **kw)
    tinf = T.inf.GradBasedInference(
        T.inf.MAP(model=tm, observed=[tm.X, tm.Y]), grad_loop=loop,
        dtype="float64", device="cpu")
    tinf.initialize(X=X, Y=Y)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    return jinf, tinf


def loss_and_grads(jinf, tinf, data):
    """((loss, {path: gradient}) of JAX, the same of the port)."""
    jex = J.inf.create_executor(jinf.inference_algorithm, jinf.params)
    jfixed = dict(jinf.params.fixed_params())
    with jax_f64():
        jl, jg = jax.value_and_grad(
            lambda tr: jex(tr, jfixed, data, jax.random.PRNGKey(0))[1])(
                dict(jinf.params.trainable_params()))
    ex = T.inf.create_executor(tinf.inference_algorithm, tinf.params)
    train = {k: v.clone().requires_grad_(True)
             for k, v in tinf.params.trainable_params().items()}
    tl = ex(train, tinf.params.fixed_params(), data,
            torch.Generator().manual_seed(0))[1]
    tl.backward()
    return ((float(jl), by_path(jinf.graphs, jg)),
            (float(tl.detach()),
             by_path(tinf.graphs, {k: v.grad for k, v in train.items()})))


def assert_same_bound(jinf, tinf, data, n_grads):
    (jl, jg), (tl, tg) = loss_and_grads(jinf, tinf, data)
    assert np.isfinite(jl)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert set(tg) == set(jg) and len(tg) == n_grads
    for path in jg:
        np.testing.assert_allclose(tg[path], jg[path], rtol=RTOL,
                                   atol=RTOL * np.abs(jg[path]).max(),
                                   err_msg=path)


def serve(jinf, tinf, Xt, chunk=64):
    """Both packages' ``BatchedPredictor`` over ``Xt`` (the port loads
    the JAX store by name path)."""
    jm, tm = jinf.graphs[0], tinf.graphs[0]
    with jax_f64():
        jout = J.inf.BatchedPredictor(
            model=jm, infr_params=jinf.params, observed=[jm.X],
            target_variables=[jm.Y.uuid], chunk_size=chunk).predict(X=Xt)[0]
    tout = T.inf.BatchedPredictor(
        model=tm, infr_params=tinf.params, observed=[tm.X],
        target_variables=[tm.Y.uuid], chunk_size=chunk).predict(X=Xt)[0]
    return [np.asarray(a) for a in jout], [np.asarray(a) for a in tout]


def labels(rng, X):
    p = 1.0 / (1.0 + np.exp(-3.0 * np.sin(2.0 * X[:, :1])))
    return (rng.random((X.shape[0], 1)) < p).astype(np.float64)


def data(seed, N, M, D=3):
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 4
    Z0 = rng.random((M, D)) * 4
    return X, labels(rng, X), Z0


# ---------------------------------------------------------------------
# the bound and its gradients
# ---------------------------------------------------------------------

@pytest.mark.parametrize("mean", [False, True], ids=["no_mean", "mean"])
@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("link", ["logit", "probit"])
@pytest.mark.parametrize("whitened", [False, True],
                         ids=["standard", "whitened"])
def test_bound_and_gradients_match_jax(whitened, link, width, mean):
    """N < 4M takes the triangular solves, N >= 4M the materialized L⁻¹
    (unwhitened) or the wide solve (whitened). Loss and every gradient
    (Z, the kernel's two, q(U)'s three) rtol 1e-10."""
    M = 8
    N = 20 if width == "narrow" else 64
    X, Y, Z0 = data(1, N, M)
    kw = dict(whitened=whitened, link=link, jitter=1e-4)
    if mean:
        kw["mean"] = np.full((N, 1), 0.4)
    jinf, tinf = pair("SVGPClassification", X, Y, Z0, **kw)
    assert_same_bound(jinf, tinf, [X, Y], 6)


def test_branch_choice_is_jax(monkeypatch):
    """The wide unwhitened arm inverts L once and floors L⁻¹Kuf at HIGH
    (``guarded_forward_matmul``); the narrow arm solves."""
    calls = []
    real = tsc.guarded_forward_matmul
    monkeypatch.setattr(tsc, "guarded_forward_matmul",
                        lambda A, B: calls.append(B.shape) or real(A, B))
    for N in (31, 32):
        X, Y, Z0 = data(2, N, 8)
        _, tinf = pair("SVGPClassification", X, Y, Z0, whitened=False)
        ex = T.inf.create_executor(tinf.inference_algorithm, tinf.params)
        ex(tinf.params.trainable_params(), tinf.params.fixed_params(),
           [X, Y], None)
    assert calls == [(1, 8, 32)]


def test_relative_jitter_and_var_floor_match_jax():
    """The jitter scales with Kuu's mean diagonal (variance 40 here: an
    absolute jitter would part the bounds at 1e-3), and moments whose
    variance cancels below 0 take the floor, as JAX's."""
    X, Y, Z0 = data(3, 12, 6)
    jinf, tinf = pair("SVGPClassification", X, Y, Z0, variance=40.0,
                      jitter=1e-2)
    assert_same_bound(jinf, tinf, [X, Y], 6)
    t = torch.tensor([-1e-12, 0.0, 0.3], dtype=torch.float64)
    for link in ("logit", "probit"):
        p = tsc._class_probability(torch.zeros(3, dtype=torch.float64), t,
                                   link, 20)
        jp = jsc._class_probability(np.zeros(3), t.numpy(), link, 20)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=RTOL)


def test_labels_broadcast_against_sampled_moments():
    """Labels with a sample axis of 1 against s = 1 moments and against
    moments of s = 3 sampled kernel variances."""
    X, Y, Z0 = data(4, 16, 5)
    jinf, tinf = pair("SVGPClassification", X, Y, Z0)
    ex = T.inf.create_executor(tinf.inference_algorithm, tinf.params)
    env = ex.build_env(tinf.params.trainable_params(),
                       tinf.params.fixed_params(), [X, Y])
    alg = tinf.inference_algorithm
    kern = alg.model.Y.factor._module_graph.kernel
    env[kern.variance.uuid] = env[kern.variance.uuid].expand(3, 1) * \
        torch.tensor([[1.0], [2.0], [3.0]], dtype=torch.float64)
    lp = tinf.graphs[0].Y.factor.log_pdf(
        env, ctx=T.inf.RuntimeContext(None))
    assert lp.shape == (3,) and bool(torch.isfinite(lp).all())
    one = float(lp[0])
    (jl, _), _ = loss_and_grads(jinf, tinf, [X, Y])
    np.testing.assert_allclose(-one, jl, rtol=RTOL)


# ---------------------------------------------------------------------
# predictions, draws, carryover, the golden
# ---------------------------------------------------------------------

@pytest.mark.parametrize("whitened", [False, True],
                         ids=["standard", "whitened"])
@pytest.mark.parametrize("link", ["logit", "probit"])
def test_predictions_match_jax(link, whitened):
    """p(y*=1) and p(1−p) through both ``BatchedPredictor``s, 150 rows in
    chunks of 64 (a padded tail), rtol 1e-10."""
    X, Y, Z0 = data(5, 40, 7)
    Xt = np.random.default_rng(6).random((150, 3)) * 4
    jinf, tinf = pair("SVGPClassification", X, Y, Z0, link=link,
                      whitened=whitened)
    jout, tout = serve(jinf, tinf, Xt)
    for j, t in zip(jout, tout):
        assert t.shape == (1, 150, 1)
        np.testing.assert_allclose(t, j, rtol=RTOL)
    assert 0.0 < tout[0].min() and tout[0].max() < 1.0


def test_forward_draws_match_jax():
    """U ~ GP(Z), F | U, p = link(F) and Y ~ Bernoulli(p) by forward
    sampling of the module graph, under the same fixed draws: the
    Bernoulli draw takes its numbers from the buffer as they are."""
    rng = np.random.default_rng(7)
    n, M, draws = 9, 5, 4
    X = rng.random((n, 2)) * 4
    Z0 = rng.random((M, 2)) * 4
    noise = rng.standard_normal(draws * (M + 2 * n))
    for link in ("logit", "probit"):
        with jax_f64():
            jm = build(J, "SVGPClassification", Z0, noise=noise, link=link)
            jinf = J.inf.Inference(J.inf.ForwardSamplingAlgorithm(
                model=jm, observed=[jm.X], num_samples=draws,
                target_variables=[jm.Y.uuid]), dtype="float64")
            jinf.initialize(X=X, key=jax.random.PRNGKey(0))
            (jy,) = jinf.run(X=X, key=jax.random.PRNGKey(0))
        tm = build(T, "SVGPClassification", Z0, noise=noise, link=link)
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


def test_carried_state_gives_the_same_bound():
    """A JAX state trained by 10 MAP steps, carried by name path into a
    fresh port model (``carryover_params``): the same parameter paths and
    the same bound."""
    from mxfusion_tpu_torch.util.carryover import carryover_params
    X, Y, Z0 = data(8, 30, 6)
    with jax_f64():
        jm = build(J, "SVGPClassification", Z0, link="probit")
        jinf = J.inf.GradBasedInference(
            J.inf.MAP(model=jm, observed=[jm.X, jm.Y]), dtype="float64")
        jinf.run(X=X, Y=Y, max_iter=10, learning_rate=0.05,
                 key=jax.random.PRNGKey(1))
    state = by_path(jinf.graphs, jinf.params.param_dict)
    assert set(state) == {"inducing_inputs", "Y.qU_mean", "Y.qU_cov_W",
                          "Y.qU_cov_diag", "Y.rbf_lengthscale",
                          "Y.rbf_variance"}
    tm = build(T, "SVGPClassification", Z0, link="probit")
    params = carryover_params(state, [tm], dtype="float64", device="cpu")
    tinf = T.inf.GradBasedInference(
        T.inf.MAP(model=tm, observed=[tm.X, tm.Y]), dtype="float64",
        device="cpu")
    tinf.initialize(X=X, Y=Y)
    assert set(params.param_dict) <= set(tinf.params.param_dict)
    tinf.params.update_params(params.param_dict)
    assert_same_bound(jinf, tinf, [X, Y], 6)


def test_golden_svgp_classification_reproduced():
    """tests/goldens/configs.py:175-201 through the port: N = 96, M = 8,
    whitened, the JAX package's initial state for PRNGKey(15), MAP + Adam
    at lr 0.05 for 50 steps. rtol 1e-5, atol 1e-8, the golden's own."""
    golden = np.load(GOLDEN)["losses"]
    N, M = 96, 8
    rng = np.random.default_rng(21)
    X = rng.random((N, 1)) * 4
    p = 1.0 / (1.0 + np.exp(-3.0 * np.sin(2.0 * X[:, :1])))
    y = (rng.random((N, 1)) < p).astype(np.float64)
    Z0 = np.linspace(0.1, 3.9, M)[:, None]
    _, tinf = pair("SVGPClassification", X, y, Z0, key=15, state={},
                   variance=1.5, lengthscale=0.7, whitened=True)
    losses = []
    tinf.run(X=X, Y=y, max_iter=50, learning_rate=0.05,
             callback=lambda i, l: losses.append(float(l)))
    np.testing.assert_allclose(losses, golden, rtol=1e-5, atol=1e-8)
