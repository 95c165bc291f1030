"""Natural-gradient SVGP training against the JAX package, float64 on the
CPU: ``_ngd_update`` (with its NaN guard), the full-batch loop's
trajectory and final state (``steps_per_call`` 1 and 2), the γ = 1 step
onto the collapsed bound (one and two outputs), the minibatch loop's
trajectory on JAX's permutations, and the loops' refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from mxfusion_tpu.inference import natural_gradient as jng
from mxfusion_tpu.inference import (NaturalGradientLoop as JNGD,
                                    NaturalGradientMinibatchLoop as JNGDMB)

from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.common.exceptions import InferenceError
from mxfusion_tpu_torch.inference import (NaturalGradientLoop,
                                          NaturalGradientMinibatchLoop)
from mxfusion_tpu_torch.inference import natural_gradient as tng

from mxfusion_tpu_torch.util.carryover import load_state

from tests.test_torch_svgp_training import (
    JInference, JMAP, JPositive, JRBF, JSVGP, GradBasedInference, MAP,
    PositiveTransformation, RBF, SVGPRegression, _by_path, _data,
    _jax_device_loop_perms, _model, jax_f64, mj, mt)

RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T / n + np.eye(n)


@pytest.mark.parametrize("definite", [True, False],
                         ids=["definite", "not_definite"])
def test_ngd_update_matches_jax(definite):
    """One step at γ = 0.7 on q(U) over D = 2 columns. A g_S whose
    2γ/D·g_S outweighs S⁻¹ makes P not positive definite: the guard keeps
    the old (m, S) in both packages, and the port says so."""
    rng = np.random.default_rng(0)
    n, D, gamma = 6, 2, 0.7
    m = rng.standard_normal((n, D))
    S = _spd(rng, n)
    g_m = rng.standard_normal((n, D))
    g_S = rng.standard_normal((n, n)) * 0.3
    if not definite:
        g_S = g_S - 20.0 * np.eye(n)
    eye = np.eye(n)
    with jax_f64():
        jm, jS = jng._ngd_update(*(jnp.asarray(a) for a in (m, S, g_m, g_S)),
                                 gamma, 1e-10, jnp.asarray(eye), float(D))
    tm, tS, bad = tng._ngd_update(
        *(torch.as_tensor(a) for a in (m, S, g_m, g_S)), gamma, 1e-10,
        torch.as_tensor(eye), float(D))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), rtol=RTOL,
                               atol=RTOL)
    assert bool(bad) is not definite
    if not definite:
        np.testing.assert_array_equal(tm.numpy(), m)
        np.testing.assert_array_equal(tS.numpy(), S)


def _setup(seed=0, N=60, M=8, D=1):
    """tests/inference/test_natural_gradient.py's data: x on [0, 4],
    sin (and cos) plus noise, Z on a grid."""
    rng = np.random.default_rng(seed)
    X = rng.random((N, 1)) * 4
    F = np.concatenate([np.sin(X), np.cos(X)], axis=1)[:, :D]
    Y = F + rng.standard_normal((N, D)) * 0.1
    Z0 = np.linspace(0.1, 3.9, M)[:, None]
    return X, Y, Z0


def _ngd_pair(X, Y, Z0, jloop, loop, key=0):
    """Both packages' SVGP regression (non-whitened, jitter 0, D columns)
    under their NGD loops, the port loaded with JAX's initial state."""
    def model(pkg, Positive, Rbf, Svgp):
        m = pkg.Model()
        m.N = pkg.Variable()
        m.X = pkg.Variable(shape=(m.N, 1))
        m.noise_var = pkg.Variable(transformation=Positive(),
                                   initial_value=0.04)
        m.Y = Svgp.define_variable(
            X=m.X, kernel=Rbf(input_dim=1, variance=1.2, lengthscale=0.8,
                              dtype="float64"),
            noise_var=m.noise_var, shape=(m.N, Y.shape[1]),
            inducing_inputs=pkg.Variable(shape=Z0.shape, initial_value=Z0),
            dtype="float64", jitter=0.0)
        return m

    with jax_f64():
        jm = model(mj, JPositive, JRBF, JSVGP)
        jinf = JInference(JMAP(model=jm, observed=[jm.X, jm.Y]),
                          grad_loop=jloop(jm), dtype="float64")
        jinf.initialize(X=X, Y=Y, key=jax.random.PRNGKey(key))
    tm = model(mt, PositiveTransformation, RBF, SVGPRegression)
    tinf = GradBasedInference(MAP(model=tm, observed=[tm.X, tm.Y]),
                              grad_loop=loop(tm), dtype="float64",
                              device="cpu")
    tinf.initialize(X=X, Y=Y)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    return jinf, tinf


def _freeze_hypers(inf):
    m = inf.graphs[0]
    gp = m.Y.factor
    kernel = gp._module_graph.kernel
    for v in (m.noise_var, kernel.lengthscale, kernel.variance,
              gp._module_graph.inducing_inputs):
        inf.params.fixed.add(v.uuid)


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_trajectory_matches_jax(steps_per_call):
    """Five steps at γ = 0.5 with Adam (lr 0.05) on the hyperparameters:
    every step's loss, the metrics of each call and the final state
    (q(U) written back as chol(S) and the frozen diagonal) at rtol
    1e-10; the loop leaves no train state."""
    X, Y, Z0 = _setup(seed=2)
    metrics = {"jax": [], "torch": []}

    def loop(which, cls):
        return lambda m: cls(module=m.Y.factor, nat_learning_rate=0.5,
                             steps_per_call=steps_per_call,
                             metrics_callback=lambda c, d: metrics[
                                 which].append(d))

    jinf, tinf = _ngd_pair(X, Y, Z0, loop("jax", JNGD),
                           loop("torch", NaturalGradientLoop))
    losses = {"jax": [], "torch": []}
    with jax_f64():
        jinf.run(max_iter=5, learning_rate=0.05, X=X, Y=Y,
                 key=jax.random.PRNGKey(0),
                 callback=lambda i, l: losses["jax"].append(l))
    tinf.run(max_iter=5, learning_rate=0.05, X=X, Y=Y,
             callback=lambda i, l: losses["torch"].append(l))
    n = 6 if steps_per_call == 2 else 5
    assert len(losses["torch"]) == len(losses["jax"]) == n
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=RTOL)
    assert len(metrics["torch"]) == len(metrics["jax"]) == n // \
        steps_per_call
    for j, t in zip(metrics["jax"], metrics["torch"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(t[key], j[key], rtol=RTOL)
    a, b = _by_path(jinf), _by_path(tinf)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=RTOL, atol=1e-12,
                                   err_msg=key)
    assert tinf.params.train_state is None
    assert tinf.grad_loop.guard_trips == 0


def _np_rbf(X, X2, ls, var):
    r2 = (((X[:, None, :] - X2[None, :, :]) / ls) ** 2).sum(-1)
    return var * np.exp(-0.5 * r2)


def _collapsed_bound(X, Y, Z, ls, var, noise):
    """The Titsias bound, max_q ELBO at fixed hyperparameters, summed over
    Y's columns."""
    Kuu = _np_rbf(Z, Z, ls, var)
    Kuf = _np_rbf(Z, X, ls, var)
    Qnn = Kuf.T @ np.linalg.solve(Kuu, Kuf)
    N = len(X)
    trace = np.trace(_np_rbf(X, X, ls, var) - Qnn) / (2 * noise)
    return sum(scipy.stats.multivariate_normal.logpdf(
        Y[:, d], np.zeros(N), Qnn + noise * np.eye(N)) - trace
        for d in range(Y.shape[1]))


@pytest.mark.parametrize("D", [1, 2], ids=["one_output", "two_outputs"])
def test_gamma_one_reaches_the_collapsed_bound(D):
    """At fixed hyperparameters and γ = 1 the first step lands on the
    optimal q(U): step 2's loss is the collapsed bound (rtol 1e-8, the
    JAX package's oracle); with D = 2 columns sharing S, the 1/D scaling
    of the natural parameters must hold for that."""
    X, Y, Z0 = _setup(seed=0 if D == 1 else 4, N=60 if D == 1 else 50,
                      M=8 if D == 1 else 6, D=D)
    _, tinf = _ngd_pair(X, Y, Z0, lambda m: None, lambda m:
                        NaturalGradientLoop(module=m.Y.factor,
                                            nat_learning_rate=1.0))
    _freeze_hypers(tinf)
    losses = []
    tinf.run(max_iter=3, learning_rate=0.0, X=X, Y=Y,
             callback=lambda i, l: losses.append(l))
    optimal = -_collapsed_bound(X, Y, Z0, 0.8, 1.2, 0.04)
    np.testing.assert_allclose(losses[1], optimal, rtol=1e-8)


def test_loops_refuse_whitened_modules_and_resume_state():
    """A whitened module, a resume state and a q(U) that is not trainable
    are refused, as in JAX."""
    X, Y, Z0 = _data(0, 20, 1, 4)
    wm = _model(mt, PositiveTransformation, RBF, SVGPRegression, Z0,
                whitened=True)
    for cls in (NaturalGradientLoop, NaturalGradientMinibatchLoop):
        with pytest.raises(InferenceError, match="whitened"):
            cls(module=wm.Y.factor)
    m = _model(mt, PositiveTransformation, RBF, SVGPRegression, Z0)
    inf = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                             grad_loop=NaturalGradientLoop(m.Y.factor),
                             dtype="float64", device="cpu")
    with pytest.raises(InferenceError, match="resume"):
        inf.run(max_iter=1, X=X, Y=Y, resume_state=object())
    inf.params.fixed.add(m.Y.factor._extra_graphs[0].qU_mean.uuid)
    with pytest.raises(InferenceError, match="not trainable"):
        inf.run(max_iter=1, X=X, Y=Y)


class _PinnedNGD(NaturalGradientMinibatchLoop):
    """The port's minibatch NGD loop fed the JAX device loop's
    permutations."""

    def __init__(self, perms, **kw):
        super().__init__(**kw)
        self._perms = perms

    def _epoch_batches(self, N, epoch):
        return list(np.array(self._perms[epoch]))


def test_minibatch_trajectory_matches_jax():
    """Four epochs of stochastic NGD (γ = 0.2, B = 50 of N = 150, N/B
    scaling) with Adam at lr 0.02 on the hyperparameters, on JAX's
    permutations: every epoch's mean loss, the gradient norm over
    (g_h, g_m, g_S), and the final state, rtol 1e-10."""
    N, B, epochs = 150, 50, 4
    X, Y, Z0 = _setup(seed=3, N=N, M=6)
    perms = _jax_device_loop_perms(jax.random.PRNGKey(0), N, B, epochs)
    metrics = {"jax": [], "torch": []}

    def jloop(m):
        return JNGDMB(module=m.Y.factor, batch_size=B,
                      rv_scaling={m.Y: N / B}, nat_learning_rate=0.2,
                      metrics_callback=lambda e, d: metrics["jax"].append(d))

    def tloop(m):
        return _PinnedNGD(perms, module=m.Y.factor, batch_size=B,
                          rv_scaling={m.Y: N / B}, nat_learning_rate=0.2,
                          metrics_callback=lambda e, d: metrics[
                              "torch"].append(d))

    jinf, tinf = _ngd_pair(X, Y, Z0, jloop, tloop)
    with jax_f64():
        jinf.run(max_iter=epochs, learning_rate=0.02, X=X, Y=Y,
                 key=jax.random.PRNGKey(0))
    tinf.run(max_iter=epochs, learning_rate=0.02, X=X, Y=Y)
    for j, t in zip(metrics["jax"], metrics["torch"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(t[key], j[key], rtol=RTOL)
    assert len(metrics["torch"]) == epochs
    assert metrics["torch"][-1]["loss"] < metrics["torch"][0]["loss"]
    a, b = _by_path(jinf), _by_path(tinf)
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=RTOL, atol=1e-12,
                                   err_msg=key)
    assert tinf.grad_loop.guard_trips == 0
