"""Mid-training checkpoints and deterministic resume in the port,
float64 on the CPU.

The port's counterparts of ``tests/inference/test_crash_resume.py`` and
``tests/util/test_checkpoint.py``: a run checkpointed by
``CheckpointCallback`` crashes, ``load_params`` restores the snapshot
(parameters, fixed set, step, generator state, optimizer state) and the
resumed run reproduces the uninterrupted trajectory to 1e-12, in the
batch loop (mean-field SVI, whose draws come from the loop's generator)
and in both minibatch loops (a 2-layer deep GP, one draw per inner layer
a step, on shuffled batches). A resume with another optimizer, other
hyperparameters or optimizer state of other shapes raises before the
first step, and the final state is published without a callback.
"""
import os

import numpy as np
import pytest
import torch

from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.inference import (DeviceMinibatchLoop,
                                          MinibatchInferenceLoop, TrainState)
from mxfusion_tpu_torch.util import (CheckpointCallback, load_params,
                                     save_params)

from tests.test_torch_svgp_classification import T, by_path
from tests.test_torch_deep_gp import build as build_deep_gp, data
from tests import test_torch_meanfield as mf


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu_in_float64():
    old = tconfig.set_default_device("cpu")
    old_dtype = tconfig.get_default_dtype()
    tconfig.set_default_dtype("float64")
    yield
    tconfig.set_default_dtype(old_dtype)
    tconfig.set_default_device(old)


class SimulatedCrash(RuntimeError):
    pass


def meanfield(n=60):
    """Identically constructed SVI runs (fresh UUIDs, the same numbers)."""
    P = mf.T
    m = P.pkg.Model()
    m.mu = P.dist.Normal.define_variable(mean=0., variance=100., shape=(1,))
    m.s = P.pkg.Variable(transformation=P.Positive(), initial_value=5.)
    m.y = P.dist.Normal.define_variable(
        mean=P.ops.broadcast_to(m.mu, (n, 1)),
        variance=P.ops.broadcast_to(m.s, (n, 1)), shape=(n, 1))
    q = P.meanfield(model=m, observed=[m.y])
    infr = T.inf.GradBasedInference(
        T.inf.StochasticVariationalInference(num_samples=8, model=m,
                                             posterior=q, observed=[m.y]),
        dtype="float64", device="cpu")
    y = np.random.default_rng(0).standard_normal((n, 1)) * 2.0 + 3.0
    return infr, {"y": y}, lambda: flat(infr)


def flat(infr):
    """Every parameter of the store, in name-path order, as one vector
    (two builds of one model have different UUIDs, the same paths)."""
    state = by_path(infr.graphs, infr.params.param_dict)
    return np.concatenate([state[p].ravel() for p in sorted(state)])


DGP_X, DGP_Y, DGP_Z0S, _ = data(3, 32, [2, 2], M=4)


def deep_gp(loop_cls):
    """A 2-layer deep GP, 4 batches of 8 an epoch, 2 draws a step from
    the loop's generator."""
    m = build_deep_gp(T, "DeepGPRegression", DGP_Z0S, num_samples=2,
                      jitter=1e-6)
    loop = loop_cls(batch_size=8, rv_scaling={m.Y: 32 / 8})
    infr = T.inf.GradBasedInference(
        T.inf.MAP(model=m, observed=[m.X, m.Y]), grad_loop=loop,
        dtype="float64", device="cpu")
    return infr, {"X": DGP_X, "Y": DGP_Y}, lambda: flat(infr)


LOOPS = {
    "batch": (meanfield, 40, 10, 25, 0.1),
    "minibatch": (lambda: deep_gp(MinibatchInferenceLoop), 6, 2, 4, 0.02),
    "device": (lambda: deep_gp(DeviceMinibatchLoop), 6, 2, 4, 0.02),
}


@pytest.mark.parametrize("loop", list(LOOPS))
def test_crash_and_resume_reproduce_the_uninterrupted_run(loop, tmp_path):
    """``total`` iterations (epochs), a checkpoint every ``every``, a
    crash after iteration ``crash``: the resumed run covers exactly the
    rest and its losses and final state equal the uninterrupted run's to
    1e-12."""
    make, total, every, crash, lr = LOOPS[loop]

    ref, data_, ref_value = make()
    ref_losses = {}
    ref.run(max_iter=total, learning_rate=lr,
            callback=lambda i, l: ref_losses.__setitem__(i, float(l)),
            **data_)

    infr, data_, value = make()
    path = str(tmp_path / "ckpt.npz")
    ckpt = CheckpointCallback(infr.params, path, every=every)
    losses, at_ckpt = {}, {}
    last_ckpt = (crash + 1) // every * every

    def crashing(i, loss):
        ckpt(i, loss)
        losses[i] = float(loss)
        if i + 1 == last_ckpt:
            at_ckpt["value"] = value()
        if i == crash:
            raise SimulatedCrash()

    with pytest.raises(SimulatedCrash):
        infr.run(max_iter=total, learning_rate=lr, callback=crashing,
                 **data_)
    for i in range(crash + 1):
        assert losses[i] == ref_losses[i], i
    assert not os.path.exists(path + ".tmp")

    state = load_params(infr.params, path)
    assert state.step == last_ckpt
    assert state.generator_state is not None and state.opt_state["state"]
    assert state.optimizer == "Adam"
    # the snapshot holds the trained state at the checkpoint
    np.testing.assert_array_equal(value(), at_ckpt["value"])

    resumed = {}
    infr.run(max_iter=total, learning_rate=lr, resume_state=state,
             callback=lambda i, l: resumed.__setitem__(i, float(l)),
             **data_)
    assert sorted(resumed) == list(range(last_ckpt, total))
    for i in range(last_ckpt, total):
        np.testing.assert_allclose(resumed[i], ref_losses[i], rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(value(), ref_value(), rtol=0, atol=1e-12)


def _checkpointed(tmp_path, steps=10):
    infr, data_, _ = meanfield()
    path = str(tmp_path / "ckpt.npz")
    infr.run(max_iter=steps, learning_rate=0.1,
             callback=CheckpointCallback(infr.params, path, every=steps),
             **data_)
    return infr, data_, load_params(infr.params, path)


@pytest.mark.parametrize("change", [
    {"optimizer": "sgd"}, {"optimizer": "adamw"}, {"learning_rate": 0.05}],
    ids=["sgd", "adamw", "learning_rate"])
def test_resume_requires_matching_optimizer(tmp_path, change):
    """Another optimizer class, or the same one with other settings,
    raises instead of loading moments that do not belong to it."""
    infr, data_, state = _checkpointed(tmp_path)
    kw = {"optimizer": "adam", "learning_rate": 0.1, **change}
    with pytest.raises(ValueError, match="optimizer"):
        infr.run(max_iter=20, resume_state=state, **kw, **data_)


def test_resume_rejects_mismatched_state_shapes_before_the_first_step(
        tmp_path):
    infr, data_, state = _checkpointed(tmp_path)
    for entries in state.opt_state["state"].values():
        entries["exp_avg"] = torch.zeros(tuple(entries["exp_avg"].shape)
                                         + (1,), dtype=torch.float64)
    before = {k: v.clone() for k, v in infr.params.param_dict.items()}
    steps = []
    with pytest.raises(ValueError, match="shape"):
        infr.run(max_iter=20, learning_rate=0.1, resume_state=state,
                 callback=lambda i, l: steps.append(i), **data_)
    assert not steps
    for k, v in before.items():
        assert torch.equal(infr.params.param_dict[k], v)


def test_final_train_state_published_without_callback(tmp_path):
    """A second, callback-less run publishes its own final state: a
    snapshot after it never pairs its parameters with the first run's
    optimizer state."""
    infr, data_, _ = meanfield()
    infr.run(max_iter=10, learning_rate=0.1, callback=lambda i, l: None,
             **data_)
    first = infr.params.train_state
    infr.run(max_iter=30, learning_rate=0.1, **data_)
    state = infr.params.train_state
    assert state is not first and state.step == 30
    path = str(tmp_path / "post.npz")
    save_params(infr.params, path)
    loaded = load_params(infr.params, path)
    assert loaded.step == 30 and loaded.opt_state["state"]
    for i, entries in state.opt_state["state"].items():
        for name, value in entries.items():
            assert torch.equal(loaded.opt_state["state"][i][name], value)
    assert torch.equal(loaded.generator_state, state.generator_state)


def test_checkpoint_roundtrip(tmp_path):
    """``tests/util/test_checkpoint.py``: the latest snapshot restores
    the trained parameters into a store that lost them, with the step
    given at save time."""
    infr, data_, value = meanfield(40)
    path = str(tmp_path / "ckpt.npz")
    infr.run(max_iter=25, learning_rate=0.1,
             callback=CheckpointCallback(infr.params, path, every=10),
             **data_)
    trained = value()
    save_params(infr.params, path, step=25)
    for k in list(infr.params.param_dict):
        infr.params.param_dict[k] = torch.zeros_like(
            infr.params.param_dict[k])
    state = load_params(infr.params, path)
    assert state.step == 25
    assert state.generator_state is not None and state.opt_state
    np.testing.assert_array_equal(value(), trained)


def test_snapshot_is_an_npz_of_arrays(tmp_path):
    """No pickle: numpy reads every entry with ``allow_pickle=False``;
    the generator state is uint8, the param groups JSON; the fixed set
    comes back."""
    infr, data_, _ = meanfield()
    infr.run(max_iter=3, learning_rate=0.1, **data_)
    infr.params.fixed.add(next(iter(infr.params.param_dict)))
    path = str(tmp_path / "snap.npz")
    save_params(infr.params, path)
    with np.load(path, allow_pickle=False) as z:
        entries = {k: z[k] for k in z.files}
    assert entries["__generator__"].dtype == np.uint8
    assert int(entries["__step__"]) == 3
    assert str(entries["__optimizer__"]) == "Adam"
    assert sum(k.startswith("param:") for k in entries) == \
        len(infr.params.param_dict)
    assert any(k.startswith("opt:") and k.endswith(":exp_avg")
               for k in entries)
    fixed = set(infr.params.fixed)
    infr.params.fixed.clear()
    load_params(infr.params, path)
    assert infr.params.fixed == fixed


def test_train_state_restore_loads_optimizer_and_generator():
    """``TrainState.restore`` sets the generator and the moments."""
    p = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([p], lr=0.1)
    p.grad = torch.ones(3, dtype=torch.float64)
    opt.step()
    g = torch.Generator().manual_seed(5)
    torch.rand(4, generator=g)
    state = TrainState(step=1, generator_state=g.get_state(),
                       opt_state=opt.state_dict(), optimizer="Adam")
    q = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    fresh = torch.optim.Adam([q], lr=0.1)
    g2 = torch.Generator().manual_seed(0)
    state.restore(fresh, g2)
    assert torch.equal(fresh.state[q]["exp_avg"], opt.state[p]["exp_avg"])
    assert torch.equal(torch.rand(4, generator=g2), torch.rand(4, generator=g))
