"""Mid-training checkpoint and deterministic resume.

Counterpart of ``mxfusion_tpu/util/checkpoint.py``. A loop callback
snapshots the full training state to npz: the parameter store, its
fixed set, the step, the loop's ``torch.Generator`` state and its
optimizer's ``state_dict``. A run restored from a snapshot reproduces
the uninterrupted run's trajectory.

Usage::

    ckpt = CheckpointCallback(infr.params, "run.npz", every=100)
    infr.run(max_iter=2000, callback=ckpt, ...)        # crashes at 512
    # --- new attempt, same process graphs ---
    state = load_params(infr.params, "run.npz")        # state.step == 500
    infr.run(max_iter=2000, callback=ckpt, resume_state=state, ...)

The file holds no pickle: arrays only (the optimizer's state tensors
one by one), the optimizer's param groups as a JSON string. It is
written to ``path + ".tmp"`` and moved into place with ``os.replace``,
so a crash while saving leaves the previous snapshot whole. Resuming rebuilds the optimizer
from the loop's ``optimizer=``/``learning_rate=`` arguments, which must
match the checkpointed run (:meth:`~..inference.grad_loop.TrainState.
restore` raises otherwise).
"""
import json
import os

import numpy as np
import torch

from .serialization import make_numpy_zip_bytes, read_numpy_zip_bytes
from ..common.placement import whole


class CheckpointCallback:
    """Pass as ``callback=`` to a gradient loop: every ``every``
    iterations (epochs, for the minibatch loops) it saves ``params``
    and the live :class:`~..inference.grad_loop.TrainState` the loop
    publishes on ``params.train_state`` before each callback."""

    def __init__(self, params, path, every=100):
        self.params = params
        self.path = path
        self.every = every

    def __call__(self, iteration, loss):
        if (iteration + 1) % self.every != 0:
            return
        save_params(self.params, self.path, step=iteration + 1)


def _host(t):
    """``t`` on the host; a parameter placed over a mesh axis whole."""
    return whole(t).detach().cpu().numpy()


def save_params(params, path, step=None):
    """Snapshot an ``InferenceParameters`` (parameters and fixed set)
    and, when a loop has published one, its ``TrainState`` (step,
    generator state, optimizer state) to ``path`` atomically."""
    payload = {"param:" + k: _host(v) for k, v in params.param_dict.items()}
    payload["__fixed__"] = np.asarray(sorted(params.fixed), dtype="U64")
    state = getattr(params, "train_state", None)
    if state is not None:
        if step is None:
            step = state.step
        if state.generator_state is not None:
            payload["__generator__"] = _host(state.generator_state)
        if state.optimizer is not None:
            payload["__optimizer__"] = np.asarray(state.optimizer)
        if state.opt_state is not None:
            for i, entries in state.opt_state["state"].items():
                for name, value in entries.items():
                    payload["opt:{}:{}".format(i, name)] = _host(value)
            payload["__opt_groups__"] = np.asarray(
                json.dumps(state.opt_state["param_groups"]))
    if step is not None:
        payload["__step__"] = np.asarray(step)
    data = make_numpy_zip_bytes(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_params(params, path):
    """Load a snapshot into ``params`` (the UUIDs must match: the same
    process graphs; across processes, go through ``Inference.save`` and
    ``load``). Parameters land on the store's device in its dtype.

    Returns the :class:`~..inference.grad_loop.TrainState`, also set as
    ``params.train_state``: pass it as ``resume_state=`` to resume the
    trajectory (``state.step`` holds the saved step)."""
    from ..inference.grad_loop import TrainState  # avoid an import cycle
    with open(path, "rb") as f:
        payload = read_numpy_zip_bytes(f.read())
    state = TrainState(step=int(payload.get("__step__", 0)))
    if "__generator__" in payload:
        state.generator_state = torch.from_numpy(payload["__generator__"])
    if "__optimizer__" in payload:
        state.optimizer = str(payload["__optimizer__"])
    if "__opt_groups__" in payload:
        entries = {}
        for k, v in payload.items():
            if k.startswith("opt:"):
                _, i, name = k.split(":", 2)
                entries.setdefault(int(i), {})[name] = torch.from_numpy(v)
        state.opt_state = {
            "state": entries,
            "param_groups": json.loads(str(payload["__opt_groups__"]))}
    params.fixed.update(str(u) for u in payload["__fixed__"].tolist())
    for k, v in payload.items():
        if k.startswith("param:"):
            params.param_dict[k[len("param:"):]] = params.as_tensor(v)
    params.train_state = state
    return state
