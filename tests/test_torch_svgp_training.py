"""The training slice against the JAX package: the SVGP bound and its
gradients, MAP, the batch, minibatch and device loops, and the golden
minibatch trajectory. Both packages start from the same state: the JAX
package initializes it, ``util.carryover.load_state`` moves it into the
port's initialized store by name path. float64 throughout."""
import contextlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxfusion_tpu as mj
from mxfusion_tpu.common import config as jconfig
from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive
from mxfusion_tpu.components.distributions.gp.kernels import RBF as JRBF
from mxfusion_tpu.inference import (MAP as JMAP,
                                    GradBasedInference as JInference,
                                    MinibatchInferenceLoop as JMinibatch,
                                    create_executor as jcreate_executor)
from mxfusion_tpu.modules import SVGPRegression as JSVGP

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.inference import (
    MAP, GradBasedInference, MinibatchInferenceLoop, DeviceMinibatchLoop,
    create_executor)
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.ops import fused_gram
from mxfusion_tpu_torch.util.carryover import load_state, name_paths


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port runs on the card unless the CPU is asked for: these tests
    ask for it, and put the previous default back afterwards."""
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "goldens", "golden_svgp_minibatch.npz")


@contextlib.contextmanager
def jax_f64():
    old = jconfig.get_default_dtype()
    jconfig.set_default_dtype("float64")
    try:
        yield
    finally:
        jconfig.set_default_dtype(old)


def _model(pkg, Positive, Rbf, Svgp, Z0, whitened=False, lengthscale=0.8):
    D = Z0.shape[1]
    m = pkg.Model()
    m.n = pkg.Variable()
    m.X = pkg.Variable(shape=(m.n, D))
    m.noise_var = pkg.Variable(transformation=Positive(), initial_value=0.1)
    m.Y = Svgp.define_variable(
        X=m.X, kernel=Rbf(input_dim=D, variance=1.0, lengthscale=lengthscale,
                          dtype="float64"),
        noise_var=m.noise_var, shape=(m.n, 1), whitened=whitened,
        inducing_inputs=pkg.Variable(shape=Z0.shape, initial_value=Z0),
        dtype="float64")
    return m


def _data(seed, N, D, M):
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 4
    Y = np.sin(2 * X[:, :1]) + rng.standard_normal((N, 1)) * 0.1
    Z0 = rng.random((M, D)) * 4
    return X, Y, Z0


def _pair(X, Y, Z0, whitened=False, jloop=None, loop=None, key=0,
          lengthscale=0.8):
    """The JAX inference, initialized from ``key``, and the port's,
    initialized and then loaded with the JAX state."""
    with jax_f64():
        jm = _model(mj, JPositive, JRBF, JSVGP, Z0, whitened, lengthscale)
        jinf = JInference(JMAP(model=jm, observed=[jm.X, jm.Y]),
                          grad_loop=jloop, dtype="float64")
        jinf.initialize(X=X, Y=Y, key=jax.random.PRNGKey(key))
    tm = _model(mt, PositiveTransformation, RBF, SVGPRegression, Z0,
                whitened, lengthscale)
    tinf = GradBasedInference(MAP(model=tm, observed=[tm.X, tm.Y]),
                              grad_loop=loop, dtype="float64", device="cpu")
    tinf.initialize(X=X, Y=Y)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    return jinf, tinf


def _by_path(inf):
    paths = name_paths(inf.graphs)
    return {paths[k]: np.asarray(v.detach() if torch.is_tensor(v) else v)
            for k, v in inf.params.param_dict.items()}


# ---------------------------------------------------------------------
# the bound and its gradients
# ---------------------------------------------------------------------

@pytest.mark.parametrize("whitened", [False, True],
                         ids=["standard", "whitened"])
@pytest.mark.parametrize("arm", ["narrow", "wide", "fused"])
def test_bound_and_gradients_match_jax(monkeypatch, whitened, arm):
    """N < 4M takes the triangular solves, N >= 4M the materialized
    L⁻¹, and "fused" forces the fused arm on the CPU: the gate is
    flipped, so the port runs the plain versions of K2 and K3 through
    the fused autograd.Function with ``lower=True``. Loss 1e-9 relative,
    gradients rtol 1e-6 and atol 1e-8: float64, where a wrong branch
    shows as O(1)."""
    M = 32
    N = 100 if arm == "narrow" else 256
    X, Y, Z0 = _data(5, N, 2, M)
    jinf, tinf = _pair(X, Y, Z0, whitened)
    calls = []
    if arm == "fused":
        monkeypatch.setattr(fused_gram, "supported", lambda *a: True)
        real = fused_gram._FusedLinvRbfGram.apply
        monkeypatch.setattr(fused_gram._FusedLinvRbfGram, "apply",
                            lambda *a: calls.append(a[-1]) or real(*a))

    jex = jcreate_executor(jinf.inference_algorithm, jinf.params)
    jfixed = dict(jinf.params.fixed_params())

    def jloss(tr):
        return jex(tr, jfixed, [X, Y], jax.random.PRNGKey(0))[1]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        dict(jinf.params.trainable_params()))
    jl = float(jl)

    ex = create_executor(tinf.inference_algorithm, tinf.params)
    train = {k: v.clone().requires_grad_(True)
             for k, v in tinf.params.trainable_params().items()}
    loss = ex(train, tinf.params.fixed_params(), [X, Y],
              torch.Generator().manual_seed(0))[1]
    loss.backward()
    assert bool(calls) == (arm == "fused")
    assert all(lower is True for lower in calls)  # L⁻¹ is declared lower
    assert abs(float(loss.detach()) - jl) <= 1e-9 * abs(jl)
    jpaths = name_paths(jinf.graphs)
    tuuid = {p: u for u, p in name_paths(tinf.graphs).items()}
    assert len(jg) == len(train) == 7
    for k, g in jg.items():
        np.testing.assert_allclose(train[tuuid[jpaths[k]]].grad.numpy(),
                                   np.asarray(g), rtol=1e-6, atol=1e-8,
                                   err_msg=jpaths[k])


def test_fused_arm_stays_off_on_cpu_by_default():
    """On the CPU the gate is closed, as in JAX on the CPU: the wide
    bound materializes Kuf."""
    X, Y, Z0 = _data(5, 256, 2, 32)
    _, tinf = _pair(X, Y, Z0)
    assert fused_gram.enabled()
    assert not fused_gram.supported(32, 256, 2, torch.float32, "cpu")
    ex = create_executor(tinf.inference_algorithm, tinf.params)
    before = fused_gram._fwd_cuda.launches
    ex(tinf.params.trainable_params(), tinf.params.fixed_params(), [X, Y],
       None)
    assert fused_gram._fwd_cuda.launches == before


def test_inference_run_evaluates_the_loss_once():
    """``Inference.run`` of a loss algorithm returns (loss,
    loss_for_gradient, aux), as the JAX package's does, here held to the
    JAX executor's loss."""
    from mxfusion_tpu_torch.inference import Inference
    X, Y, Z0 = _data(6, 60, 2, 8)
    jinf, tinf = _pair(X, Y, Z0)
    plain = Inference(tinf.inference_algorithm, dtype="float64",
                      device="cpu")
    plain.params = tinf.params
    plain._initialized = True
    loss, loss_for_grad, aux = plain.run(X=X, Y=Y)
    jex = jcreate_executor(jinf.inference_algorithm, jinf.params)
    jfixed = dict(jinf.params.fixed_params())
    jloss = jax.jit(lambda tr: jex(tr, jfixed, [X, Y],
                                   jax.random.PRNGKey(0))[0])(
        dict(jinf.params.trainable_params()))
    assert aux == {}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-12)
    assert torch.equal(loss, loss_for_grad)


# ---------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------

def test_minibatch_trajectory_matches_jax(monkeypatch):
    """MAP + MinibatchInferenceLoop + Adam for 3 epochs of 4 batches
    (the last one rolled over), with both packages' loaders forced to
    their numpy fallback (as ``tests/native/test_fast_batcher.py``
    forces JAX's), so that path stays covered; the native path is
    ``tests/test_torch_native_batcher.py``'s. Per-epoch losses rtol
    1e-6, final parameters rtol 1e-5 (atol 1e-8)."""
    from mxfusion_tpu.native import loader as jloader
    from mxfusion_tpu_torch.native import loader as tloader
    for ldr in (jloader, tloader):
        monkeypatch.setattr(ldr, "_LIB", None)
        monkeypatch.setattr(ldr, "_TRIED", True)
    N, B = 230, 64
    X, Y, Z0 = _data(7, N, 2, 12)
    with jax_f64():
        jm_loop = JMinibatch(batch_size=B)
    jinf, tinf = _pair(X, Y, Z0, jloop=jm_loop,
                       loop=MinibatchInferenceLoop(batch_size=B), key=3)
    jm, tm = jinf.graphs[0], tinf.graphs[0]
    jm_loop.rv_scaling = {jm.Y.uuid: N / B}
    tinf.grad_loop.rv_scaling = {tm.Y.uuid: N / B}
    jl, tl = [], []
    with jax_f64():
        jinf.run(max_iter=3, learning_rate=0.05, X=X, Y=Y,
                 key=jax.random.PRNGKey(3),
                 callback=lambda e, l: jl.append(float(l)))
    tinf.run(max_iter=3, learning_rate=0.05, X=X, Y=Y,
             callback=lambda e, l: tl.append(float(l)))
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    jp, tp = _by_path(jinf), _by_path(tinf)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-8,
                                   err_msg=k)


def test_batch_trajectory_matches_jax():
    """MAP + BatchInferenceLoop (the default loop) + Adam, 20 steps,
    whitened. Each step's loss is read at the pre-update parameters, as
    in JAX. Losses rtol 1e-6, final parameters rtol 1e-5 (atol 1e-8)."""
    X, Y, Z0 = _data(8, 90, 2, 10)
    jinf, tinf = _pair(X, Y, Z0, whitened=True, key=4)
    jl, tl = [], []
    with jax_f64():
        jinf.run(max_iter=20, learning_rate=0.05, X=X, Y=Y,
                 key=jax.random.PRNGKey(4),
                 callback=lambda i, l: jl.append(float(l)))
    final = tinf.run(max_iter=20, learning_rate=0.05, X=X, Y=Y,
                     callback=lambda i, l: tl.append(float(l)))
    assert len(tl) == len(jl) == 20
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(float(final), jl[-1], rtol=1e-6)
    jp, tp = _by_path(jinf), _by_path(tinf)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    state = tinf.params.train_state
    assert state.step == 20 and state.opt_state["state"]


def test_batch_loop_steps_per_call_and_metrics():
    """``steps_per_call = k`` keeps the JAX API as a plain loop: the
    callback sees every k-th step with that step's loss, and the run
    equals the one-step loop's."""
    from mxfusion_tpu_torch.inference import BatchInferenceLoop
    X, Y, Z0 = _data(8, 40, 2, 6)
    runs = {}
    for k in (1, 4):
        seen, metrics = [], []
        _, tinf = _pair(X, Y, Z0, key=4, loop=BatchInferenceLoop(
            steps_per_call=k,
            metrics_callback=lambda i, m: metrics.append((i, m))))
        tinf.run(max_iter=8, learning_rate=0.05, X=X, Y=Y,
                 callback=lambda i, l: seen.append((i, float(l))))
        runs[k] = (seen, metrics, _by_path(tinf))
    (one, m1, p1), (four, m4, p4) = runs[1], runs[4]
    assert [i for i, _ in four] == [3, 7]
    assert four == [one[3], one[7]]
    assert [i for i, _ in m4] == [3, 7]
    assert set(m1[0][1]) == {"loss", "grad_norm", "step_time_s"}
    assert m1[0][1]["grad_norm"] > 0
    for key in p1:
        np.testing.assert_array_equal(p4[key], p1[key])


@pytest.mark.parametrize("minibatch", [False, True])
def test_resume_state_continues_the_uninterrupted_run(minibatch):
    """A run resumed from the TrainState a loop publishes (step, the
    generator's state, the optimizer's state_dict) ends where the
    uninterrupted run ends."""
    X, Y, Z0 = _data(8, 40, 2, 6)

    def make():
        loop = MinibatchInferenceLoop(batch_size=16) if minibatch else None
        _, tinf = _pair(X, Y, Z0, key=4, loop=loop)
        if minibatch:
            loop.rv_scaling = {tinf.graphs[0].Y.uuid: 40 / 16}
        return tinf

    whole = make()
    whole.run(max_iter=6, learning_rate=0.05, X=X, Y=Y)
    part = make()
    part.run(max_iter=3, learning_rate=0.05, X=X, Y=Y)
    state = part.params.train_state
    assert state.step == 3
    part.run(max_iter=6, learning_rate=0.05, X=X, Y=Y, resume_state=state)
    a, b = _by_path(whole), _by_path(part)
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=1e-12, err_msg=key)


class _JaxPermutationLoop(DeviceMinibatchLoop):
    """The port's device loop fed the permutations that the JAX device
    loop derives from its key (``device_loop.py:163-167, 183-184,
    203``)."""

    def __init__(self, perms, **kw):
        super().__init__(**kw)
        self._perms = perms

    def _epoch_batches(self, N, epoch):
        return list(np.array(self._perms[epoch]))  # writable rows


def _jax_device_loop_perms(key, N, B, epochs):
    n_batches = -(-N // B)
    pad = n_batches * B - N
    out = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        pkey, _ = jax.random.split(sub)
        perm = jax.random.permutation(pkey, N)
        if pad:
            perm = jnp.concatenate([perm, perm[:pad]])
        out.append(np.asarray(perm).reshape(n_batches, B))
    return out


def test_golden_svgp_minibatch_reproduced():
    """tests/goldens/configs.py:141-171 through the port: the same
    data, the JAX package's initial state for PRNGKey(14) and its
    device-loop permutations, 12 epochs. rtol 1e-5, the golden's own."""
    golden = np.load(GOLDEN)["losses"]
    N, D, M, B = 2000, 2, 16, 256
    rng = np.random.default_rng(3)
    X = rng.random((N, D)) * 4
    y = (np.sin(X[:, :1]) + np.cos(X[:, 1:2])
         + rng.standard_normal((N, 1)) * 0.1)
    Z0 = rng.random((M, D)) * 4
    perms = _jax_device_loop_perms(jax.random.PRNGKey(14), N, B, 12)
    jinf, tinf = _pair(X, y, Z0, key=14, lengthscale=1.0,
                       loop=_JaxPermutationLoop(perms, batch_size=B))
    tm = tinf.graphs[0]
    tinf.grad_loop.rv_scaling = {tm.Y.uuid: N / B}
    losses = []
    tinf.run(max_iter=12, learning_rate=0.02, X=X, Y=y,
             callback=lambda e, l: losses.append(l))
    np.testing.assert_allclose(losses, golden, rtol=1e-5, atol=1e-8)


def test_device_loop_batches_are_device_permutations():
    loop = DeviceMinibatchLoop(batch_size=4)
    loop._perm_generator = torch.Generator()
    b = loop._epoch_batches(10, 0)
    assert b.shape == (3, 4)
    assert sorted(b.reshape(-1)[:10].tolist()) == list(range(10))
    assert torch.equal(b.reshape(-1)[10:], b.reshape(-1)[:2])
    assert torch.equal(b, loop._epoch_batches(10, 0))
    assert not torch.equal(b, loop._epoch_batches(10, 1))
    # shard_local_shuffle is ported (tests/test_torch_parallel.py runs
    # it over a mesh); without a sharded dataset it raises as JAX's does
    local = DeviceMinibatchLoop(batch_size=4, shard_local_shuffle=True)
    params = types.SimpleNamespace(device=torch.device("cpu"))
    with pytest.raises(ValueError, match="data_sharding"):
        local.run(None, params, [np.zeros((8, 1))])


def test_array_rv_scaling_raises_until_masks_are_ported():
    """Observation masks are ported; on the SVGP's module-generated Y an
    array rv_scaling raises, as in JAX (the module bound scales its
    already-summed data term, so only a scalar composes)."""
    from mxfusion_tpu_torch.common.exceptions import InferenceError
    X, Y, Z0 = _data(6, 30, 2, 4)
    _, tinf = _pair(X, Y, Z0)
    with pytest.raises(InferenceError, match="module-generated"):
        create_executor(tinf.inference_algorithm, tinf.params,
                        rv_scaling={tinf.graphs[0].Y.uuid: np.ones((30, 1))})


# ---------------------------------------------------------------------
# MAP's pieces: PointMass, support transformations; predictive samples
# ---------------------------------------------------------------------

def test_map_over_a_latent_matches_jax():
    """A latent Normal mean under MAP: the posterior puts a PointMass on
    it, its location is trained. 20 Adam steps, losses rtol 1e-9."""
    from mxfusion_tpu.components.distributions import Normal as JNormal
    from mxfusion_tpu.components.functions.operators import \
        broadcast_to as jbroadcast
    from mxfusion_tpu_torch.components.distributions import Normal
    from mxfusion_tpu_torch.components.distributions.pointmass import \
        PointMass
    from mxfusion_tpu_torch.components.functions.operators import \
        broadcast_to
    N = 40
    y = np.random.default_rng(9).standard_normal((N, 1)) * 2.0 + 3.0

    def build(pkg, Norm, bcast):
        # named constants: unnamed ones would share a name path
        m = pkg.Model()
        m.zero = pkg.Variable(value=0.)
        m.wide = pkg.Variable(value=100.)
        m.one = pkg.Variable(value=1.)
        m.mu = Norm.define_variable(mean=m.zero, variance=m.wide,
                                    shape=(1,))
        m.y = Norm.define_variable(mean=bcast(m.mu, (N, 1)),
                                   variance=bcast(m.one, (N, 1)),
                                   shape=(N, 1))
        return m

    with jax_f64():
        jm = build(mj, JNormal, jbroadcast)
        jinf = JInference(JMAP(model=jm, observed=[jm.y]), dtype="float64")
        jinf.initialize(y=y, key=jax.random.PRNGKey(2))
    tm = build(mt, Normal, broadcast_to)
    tinf = GradBasedInference(MAP(model=tm, observed=[tm.y]),
                              dtype="float64", device="cpu")
    tinf.initialize(y=y)
    q = tinf.inference_algorithm.posterior
    assert isinstance(q[tm.mu].factor, PointMass)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    jl, tl = [], []
    with jax_f64():
        jinf.run(max_iter=20, learning_rate=0.1, y=y,
                 key=jax.random.PRNGKey(2),
                 callback=lambda i, l: jl.append(float(l)))
    tinf.run(max_iter=20, learning_rate=0.1, y=y,
             callback=lambda i, l: tl.append(float(l)))
    np.testing.assert_allclose(tl, jl, rtol=1e-9)


@pytest.mark.parametrize("name", ["Logistic", "SimplexTransformation"])
def test_support_transformations_match_jax(name):
    from mxfusion_tpu.components.variables import var_trans as jvt
    from mxfusion_tpu_torch.components.variables import var_trans as tvt
    args = (-1.0, 3.0) if name == "Logistic" else ()
    jt, tt = getattr(jvt, name)(*args), getattr(tvt, name)(*args)
    x = np.random.default_rng(10).standard_normal((3, 4)) * 3
    y = tt.transform(torch.as_tensor(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jt.transform(
        jnp.asarray(x))), rtol=1e-12)
    for value in (y, y.numpy()):
        back = tt.inverse_transform(value)
        np.testing.assert_allclose(
            np.asarray(tt.transform(torch.as_tensor(back))), y.numpy(),
            rtol=1e-10)
        np.testing.assert_allclose(np.asarray(back), np.asarray(
            jt.inverse_transform(jnp.asarray(np.asarray(value)))),
            rtol=1e-10)


@pytest.mark.parametrize("diagonal", [True, False])
def test_sampling_prediction_matches_jax(diagonal):
    """SVGPRegressionSamplingPrediction with the same draws fed to both
    packages (``FixedRandomGenerator``); rtol 1e-9."""
    from mxfusion_tpu.components.distributions.random_gen import \
        FixedRandomGenerator as JFixed
    from mxfusion_tpu.inference import TransferInference as JTransfer
    from mxfusion_tpu.modules.gp_modules.svgp_regression import \
        SVGPRegressionSamplingPrediction as JSampling
    from mxfusion_tpu_torch.components.distributions.random_gen import \
        FixedRandomGenerator
    from mxfusion_tpu_torch.inference import TransferInference
    from mxfusion_tpu_torch.modules.gp_modules.svgp_regression import \
        SVGPRegressionSamplingPrediction as Sampling
    X, Y, Z0 = _data(11, 50, 2, 6)
    jinf, tinf = _pair(X, Y, Z0)
    Xt = np.random.default_rng(12).random((9, 2)) * 4
    draws = np.random.default_rng(13).standard_normal(3 * 9)
    outs = []
    for model, Alg, Transfer, Fixed, params, extra in (
            (jinf.graphs[0], JSampling, JTransfer, JFixed, jinf.params,
             {"key": jax.random.PRNGKey(0)}),
            (tinf.graphs[0], Sampling, TransferInference,
             FixedRandomGenerator, tinf.params,
             {"generator": torch.Generator()})):
        mod = model.Y.factor
        alg = Alg(mod._module_graph, mod._extra_graphs[0], [model.X],
                  rand_gen=Fixed(draws), diagonal_variance=diagonal,
                  jitter=mod.jitter)
        alg.num_samples = 3
        alg.target_variables = [model.Y.uuid]
        with jax_f64():
            run = Transfer(alg, infr_params=params)
            outs.append(np.asarray(run.run(X=Xt, **extra)[0]))
    assert outs[1].shape == (3, 9, 1)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-9, atol=1e-10)
