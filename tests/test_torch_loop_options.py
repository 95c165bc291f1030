"""The loops' options against the JAX package, and faults C2-C3.

* ``ops.precision.einsum`` with one, two and three operands (C2; C3's
  ``ops.batched_cholesky`` is ``tests/test_torch_public_api.py``'s), in
  float64 against JAX's, forward and gradients, the tier pinned both
  ways.
* ``MinibatchInferenceLoop(batches_per_call=k)``:
  ``tests/inference/test_scanned_minibatch.py``'s three cases, JAX's
  per-epoch losses at k = 3, and one host-to-device copy a call.
* ``create_executor(remat=True)``: the plain executor's loss and
  gradients on a MAP objective, a sampled SVI objective (one generator
  seed) and the SVGP bound, at rtol 1e-12, and an SVI trajectory equal
  to the one without (the generator replayed in the recompute).
* ``BatchInferenceLoop(debug=)``, accepted and without effect.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxfusion_tpu.inference import MinibatchInferenceLoop as JMinibatch
from mxfusion_tpu.ops import precision as jprecision
from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    MAP, BatchInferenceLoop, GradBasedInference, MinibatchInferenceLoop,
    ModulePredictionAlgorithm, StochasticVariationalInference,
    TransferInference, create_Gaussian_meanfield, create_executor)
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.native import native_available
from mxfusion_tpu_torch.ops import precision

from tests.test_torch_svgp_training import _data, _pair, jax_f64


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    old = tconfig.set_default_device("cpu")
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(torch_threads)
    tconfig.set_default_device(old)


# ---------------------------------------------------------------------
# C2: precision.einsum of one, two and three operands
# ---------------------------------------------------------------------

EINSUMS = [
    ("ij->ji", [(3, 4)]),
    ("...ii->...i", [(2, 3, 3)]),
    ("...ij,...jk->...ik", [(2, 3, 4), (2, 4, 5)]),
    ("ij,jk,kl->il", [(3, 4), (4, 5), (5, 2)]),
    ("...ij,...jk,...kl->...il", [(2, 3, 4), (2, 4, 5), (1, 5, 2)]),
    ("bi,bij,bj->b", [(3, 4), (3, 4, 5), (3, 5)]),
]


@pytest.mark.parametrize("eq,shapes", EINSUMS,
                         ids=[e for e, _ in EINSUMS])
def test_einsum_of_each_arity_matches_jax(eq, shapes):
    rng = np.random.default_rng(len(eq))
    arrays = [rng.standard_normal(s) for s in shapes]
    out_j, vjp = jax.vjp(lambda *ops: jprecision.einsum(eq, *ops),
                         *map(jnp.asarray, arrays))
    g = rng.standard_normal(out_j.shape)
    grads_j = vjp(jnp.asarray(g))
    ops = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    out = precision.einsum(eq, *ops)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-12, atol=1e-12)
    for t, gj in zip(ops, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_ops", [1, 2, 3])
def test_einsum_pins_highest_both_ways(monkeypatch, n_ops):
    """Each pairwise product asks for HIGHEST forward and backward; one
    operand has no product and asks for nothing."""
    asked = []
    real = precision._pinned
    monkeypatch.setattr(precision, "_pinned",
                        lambda t, x: asked.append(t) or real(t, x))
    eq = {1: "ij->i", 2: "ij,jk->ik", 3: "ij,jk,kl->il"}[n_ops]
    ops = [torch.ones((3, 3), requires_grad=True) for _ in range(n_ops)]
    out = precision.einsum(eq, *ops)
    assert asked == ["highest"] * (n_ops - 1)
    out.sum().backward()
    assert asked == ["highest"] * (2 * (n_ops - 1))


def test_einsum_arity_errors():
    with pytest.raises(ValueError, match="one, two or three"):
        precision.einsum("i,i,i,i->i", *[torch.ones(2)] * 4)
    with pytest.raises(ValueError, match="three operands"):
        precision.einsum("ij,jk->ik", *[torch.ones(2, 2)] * 3)


# ---------------------------------------------------------------------
# batches_per_call (tests/inference/test_scanned_minibatch.py)
# ---------------------------------------------------------------------

N, B = 240, 40


def _normal_model(n=None):
    m = Model()
    m.n = Variable()
    rows = m.n if n is None else n
    m.mu = Normal.define_variable(mean=0., variance=100., shape=(1,))
    m.s = Variable(transformation=PositiveTransformation(),
                   initial_value=5.)
    m.y = Normal.define_variable(mean=broadcast_to(m.mu, (rows, 1)),
                                 variance=broadcast_to(m.s, (rows, 1)),
                                 shape=(rows, 1))
    return m


def _svi(m, S=8):
    q = create_Gaussian_meanfield(model=m, observed=[m.y])
    return q, StochasticVariationalInference(num_samples=S, model=m,
                                             posterior=q, observed=[m.y])


def test_scanned_minibatch_svi_converges():
    rng = np.random.default_rng(0)
    y = rng.standard_normal((N, 1)) * 2.0 + 3.0
    m = _normal_model()
    q, alg = _svi(m)
    loop = MinibatchInferenceLoop(batch_size=B, rv_scaling={m.y: N / B},
                                  batches_per_call=3)
    infr = GradBasedInference(inference_algorithm=alg, grad_loop=loop)
    infr.run(max_iter=40, learning_rate=0.1, y=y)
    mu_post = float(infr.params[q.mu.factor.mean])
    assert abs(mu_post - y.mean()) < 0.5
    # 6 batches an epoch, 2 calls of 3: one host-to-device copy a call
    assert loop.h2d_copies == 40 * 2


def _svgp(Z0):
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, 1))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=1), noise_var=m.noise_var,
        shape=(m.n, 1),
        inducing_inputs=Variable(shape=(12, 1), initial_value=Z0))
    return m


def test_scanned_minibatch_svgp_with_prediction():
    rng = np.random.default_rng(1)
    X = rng.random((N, 1)) * 4
    Y = np.sin(X) + rng.standard_normal((N, 1)) * 0.1
    m = _svgp(np.linspace(0, 4, 12)[:, None])
    loop = MinibatchInferenceLoop(batch_size=B, rv_scaling={m.Y: N / B},
                                  batches_per_call=4)
    infr = GradBasedInference(
        inference_algorithm=MAP(model=m, observed=[m.X, m.Y]),
        grad_loop=loop)
    infr.run(max_iter=60, learning_rate=0.05, X=X, Y=Y)
    Xt = np.linspace(0, 4, 15)[:, None]
    pred = TransferInference(ModulePredictionAlgorithm(
        model=m, observed=[m.X], target_variables=[m.Y.uuid]),
        infr_params=infr.params)
    mu, _ = pred.run(X=Xt)[0]
    err = np.abs(mu.detach().numpy()[0] - np.sin(Xt)).mean()
    assert err < 0.25
    # 6 batches padded to 8 by wrapping: 2 calls, 8 steps an epoch
    assert loop.h2d_copies == 60 * 2


def test_minibatch_batch_size_exceeds_dataset():
    """batch_size > N (even > 2N) clamps to N-sized batches matching the
    bound symbolic dim; with k = 2 the one batch an epoch wraps to two
    (JAX's wrap indexes past the batches there and raises)."""
    rng = np.random.default_rng(3)
    y = rng.standard_normal((25, 1)) + 1.5
    m = _normal_model()
    q, alg = _svi(m)
    loop = MinibatchInferenceLoop(batch_size=64, rv_scaling={m.y: 1.0},
                                  batches_per_call=2)
    infr = GradBasedInference(inference_algorithm=alg, grad_loop=loop)
    infr.run(max_iter=30, learning_rate=0.1, y=y)
    mu_post = float(infr.params[q.mu.factor.mean])
    assert abs(mu_post - y.mean()) < 0.6


def test_a_call_is_one_host_buffer():
    """The k batches of a call are views of one buffer: the arrays of
    every batch share one storage."""
    loop = MinibatchInferenceLoop(batch_size=8, batches_per_call=3)
    data = [np.arange(40.0).reshape(20, 2), np.arange(20)]
    idx = np.stack(loop._epoch_calls(20, 0)[0])
    batches = loop._stage(data, idx, torch.device("cpu"))
    assert loop.h2d_copies == 1
    ptrs = {a.untyped_storage().data_ptr() for b in batches for a in b}
    assert len(ptrs) == 1
    for b, i in zip(batches, idx):
        assert np.array_equal(b[0].numpy(), data[0][i])
        assert np.array_equal(b[1].numpy(), data[1][i])


@pytest.mark.skipif(not native_available(),
                    reason="no C++ compiler: JAX's batches would differ")
@pytest.mark.parametrize("k", [1, 3])
def test_batches_per_call_losses_match_jax(k):
    """MAP SVGP in float64, 3 epochs of 4 batches padded by wrapping to a
    multiple of k: JAX's per-epoch losses (the mean of its calls' means)
    at rtol 1e-6, both loaders native."""
    n, b = 230, 64
    X, Y, Z0 = _data(11, n, 2, 10)
    with jax_f64():
        jloop = JMinibatch(batch_size=b, batches_per_call=k)
    jinf, tinf = _pair(X, Y, Z0, jloop=jloop, key=5,
                       loop=MinibatchInferenceLoop(batch_size=b,
                                                   batches_per_call=k))
    jloop.rv_scaling = {jinf.graphs[0].Y.uuid: n / b}
    tinf.grad_loop.rv_scaling = {tinf.graphs[0].Y.uuid: n / b}
    jl, tl = [], []
    with jax_f64():
        jinf.run(max_iter=3, learning_rate=0.05, X=X, Y=Y,
                 key=jax.random.PRNGKey(5),
                 callback=lambda e, l: jl.append(float(l)))
    tinf.run(max_iter=3, learning_rate=0.05, X=X, Y=Y,
             callback=lambda e, l: tl.append(float(l)))
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert tinf.grad_loop.h2d_copies == 3 * -(-4 // k)


# ---------------------------------------------------------------------
# remat (tests/util/test_profiling_remat.py)
# ---------------------------------------------------------------------

def _loss_and_grads(executor, tr, fx, data, seed):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tr.items()}
    g = torch.Generator().manual_seed(seed)
    loss, lfg, _ = executor(leaves, fx, data, g)
    lfg.backward()
    return (float(loss.detach()), {k: v.grad for k, v in leaves.items()},
            g.get_state())


def _remat_case(alg, infr, data, seed=0):
    tr = infr.params.trainable_params()
    fx = infr.params.fixed_params()
    plain = _loss_and_grads(create_executor(alg, infr.params), tr, fx,
                            data, seed)
    remat = _loss_and_grads(create_executor(alg, infr.params, remat=True),
                            tr, fx, data, seed)
    np.testing.assert_allclose(remat[0], plain[0], rtol=1e-12)
    for k, g in plain[1].items():
        if g is None:  # a parameter the objective does not reach
            assert remat[1][k] is None
            continue
        np.testing.assert_allclose(remat[1][k].numpy(), g.numpy(),
                                   rtol=1e-12, atol=1e-300)
    # the generator ends where the plain executor leaves it
    assert torch.equal(remat[2], plain[2])
    return plain


def test_remat_executor_matches_plain_on_map():
    rng = np.random.default_rng(0)
    y = rng.standard_normal((30, 1))
    m = Model()
    m.mu = Variable(initial_value=0.0)
    m.y = Normal.define_variable(
        mean=broadcast_to(m.mu, (30, 1)),
        variance=broadcast_to(Variable(value=1.0), (30, 1)),
        shape=(30, 1))
    alg = MAP(model=m, observed=[m.y])
    infr = GradBasedInference(inference_algorithm=alg, dtype="float64")
    infr.initialize(y=y)
    _remat_case(alg, infr, [y])


def test_remat_executor_matches_plain_on_sampled_svi():
    """Mean-field SVI at S = 4: the recompute draws the forward's
    numbers again from the explicit generator."""
    rng = np.random.default_rng(1)
    y = rng.standard_normal((50, 1)) + 2.0
    m = _normal_model(50)
    q, alg = _svi(m, S=4)
    infr = GradBasedInference(inference_algorithm=alg, dtype="float64")
    infr.initialize(y=y)
    _remat_case(alg, infr, [y], seed=7)


def test_remat_executor_matches_plain_on_the_svgp_bound():
    X, Y, Z0 = _data(3, 60, 2, 8)
    _, tinf = _pair(X, Y, Z0)
    alg = tinf.inference_algorithm
    _remat_case(alg, tinf, [X, Y])


def test_remat_recomputes_the_objective(monkeypatch):
    rng = np.random.default_rng(2)
    y = rng.standard_normal((20, 1))
    m = _normal_model(20)
    q, alg = _svi(m, S=4)
    infr = GradBasedInference(inference_algorithm=alg, dtype="float64")
    infr.initialize(y=y)
    calls = []
    real = alg.compute
    monkeypatch.setattr(alg, "compute",
                        lambda env, ctx: calls.append(1) or real(env, ctx))
    for remat, n_calls in ((False, 1), (True, 2)):
        calls.clear()
        _loss_and_grads(create_executor(alg, infr.params, remat=remat),
                        infr.params.trainable_params(),
                        infr.params.fixed_params(), [y], 0)
        assert len(calls) == n_calls


def test_remat_svi_trajectory_equals_the_plain_one():
    """Five SVI steps through ``GradBasedInference.run(remat=True)``:
    each step's draws are those of the run without remat."""
    rng = np.random.default_rng(4)
    y = rng.standard_normal((40, 1)) + 1.0
    runs = []
    for remat in (False, True):
        m = _normal_model(40)
        q, alg = _svi(m, S=4)
        infr = GradBasedInference(inference_algorithm=alg, dtype="float64")
        losses = []
        infr.run(max_iter=5, learning_rate=0.1, y=y, remat=remat,
                 generator=torch.Generator().manual_seed(3),
                 callback=lambda i, l: losses.append(float(l)))
        runs.append(losses)
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-12)


# ---------------------------------------------------------------------
# debug
# ---------------------------------------------------------------------

def test_batch_loop_accepts_debug_and_runs_the_same():
    rng = np.random.default_rng(5)
    y = rng.standard_normal((30, 1)) + 1.0
    runs = []
    for debug in (False, True):
        m = _normal_model(30)
        q, alg = _svi(m, S=2)
        loop = BatchInferenceLoop(debug=debug)
        assert loop.debug is debug
        infr = GradBasedInference(inference_algorithm=alg, grad_loop=loop,
                                  dtype="float64")
        losses = []
        infr.run(max_iter=4, learning_rate=0.1, y=y,
                 callback=lambda i, l: losses.append(float(l)))
        runs.append(losses)
    assert runs[0] == runs[1]
