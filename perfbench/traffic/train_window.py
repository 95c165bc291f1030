"""Training traffic: minibatch MAP with Adam over rows resident on the
device, whole epochs of the port's ``DeviceMinibatchLoop`` through
``GradBasedInference.run``.

Set-up builds one inference, loads the configuration's start from the
seed, and runs epochs 0 and 1 through the same call as the window; the
second is timed to fix how many epochs the window runs: as many as fill
``--seconds``. The window resumes the same inference from its train
state, one ``run`` call, and ends at its last epoch's host sync. Its
first ``check_steps`` steps are recorded: the state they start from
(parameters, Adam's moments and step count, the draws' generator), each
step's loss and rows, Adam's first moment after the first step and the
parameters after the last. Once the window has closed, the reference
follows those steps from that state.

Parameters (the workload's ``traffic`` object): ``rows`` resident,
``batch``, ``learning_rate``, ``check_steps``, ``trace_epochs`` (the
window of a traced run).
"""
import math
import time

import torch

from ..lib import compare
from ..lib.phases import phase_logger


def recording_loop(base):
    """``base`` (a minibatch loop class) that records the first
    ``check_steps`` steps of the run that follows :meth:`watch`: the
    state the first starts from, the index batches, each step's loss,
    Adam's first moment after the first step and the parameters after
    the last. It observes only: every step runs as ``base``'s."""

    class RecordingLoop(base):
        def watch(self, check_steps):
            self._left = check_steps
            self.losses, self.first_moment, self.after = [], None, None
            self.first_rows = self.start = None

        def _epoch_batches(self, N, epoch):
            idx = base._epoch_batches(self, N, epoch)
            if getattr(self, "_left", 0) and self.first_rows is None:
                self.first_rows = idx[:self._left].clone()
            return idx

        def _step(self, executor, opt, trainable, fixed, batch, generator,
                  grad_norm=False):
            if getattr(self, "_left", 0) and self.start is None:
                self.start = {
                    "params": {k: p.detach().clone()
                               for k, p in trainable.items()},
                    "adam": {k: adam_state(opt, p)
                             for k, p in trainable.items()},
                    "generator": None if generator is None
                    else generator.get_state()}
            out = base._step(self, executor, opt, trainable, fixed, batch,
                             generator, grad_norm)
            if getattr(self, "_left", 0):
                self.losses.append(out[0].clone())
                if self.first_moment is None:
                    self.first_moment = {k: adam_state(opt, p)[0]
                                         for k, p in trainable.items()}
                self._left -= 1
                if not self._left:
                    self.after = {k: p.detach().clone()
                                  for k, p in trainable.items()}
            return out

    return RecordingLoop


def adam_state(opt, p):
    """(first moment, second moment, steps taken) of Adam for ``p``;
    zeros and 0 before its first step."""
    st = opt.state.get(p, {})
    if "exp_avg" not in st:
        return torch.zeros_like(p), torch.zeros_like(p), 0
    return (st["exp_avg"].detach().clone(), st["exp_avg_sq"].detach().clone(),
            int(st["step"]))


class Cell:
    """One training cell: ``setup``, ``window``, ``release``, ``check``."""

    def __init__(self, workload, config, cfg, reference, seed, device):
        self.traffic = workload["traffic"]
        self.config, self.cfg, self.reference = config, cfg, reference
        self.seed, self.device = seed, device
        self.rows, self.batch = self.traffic["rows"], self.traffic["batch"]
        self.steps_per_epoch = -(-self.rows // self.batch)

    def _generator(self, offset):
        return torch.Generator(self.device).manual_seed(
            (self.seed * 8 + offset) % 2 ** 63)

    def setup(self, seconds, log=lambda *a: None):
        phase = phase_logger(log)
        from mxfusion_tpu_torch.inference import (
            DeviceMinibatchLoop, GradBasedInference, MAP)
        from mxfusion_tpu_torch.util.carryover import load_state, name_paths
        cfg, tr = self.cfg, self.traffic
        phase("import")
        self.X, self.Y = self.config.data(cfg, self.rows, self._generator(1))
        self.initial = self.config.initial_state(cfg, self._generator(2))
        phase("data and start on the card")
        m = self.config.model(cfg)
        loop = recording_loop(DeviceMinibatchLoop)(
            batch_size=self.batch, rv_scaling={m.Y: self.rows / self.batch})
        self.inference = GradBasedInference(
            MAP(model=m, observed=[m.X, m.Y]), grad_loop=loop,
            dtype="float32", device=self.device)
        self.inference.initialize(X=self.X[:self.batch], Y=self.Y[:self.batch],
                                  generator=self._generator(3))
        load_state(self.inference.params,
                   {k: v.clone() for k, v in self.initial.items()},
                   self.inference.graphs)
        self.names = name_paths(self.inference.graphs)
        phase("model and inference")
        # the generator of the runs' draws
        self.generator = self._generator(4)
        self._run(1)
        phase("epoch 0")
        t0 = time.perf_counter()
        self._run(2)
        epoch_s = time.perf_counter() - t0
        phase("epoch 1")
        self.epochs_done = 2
        self.window_epochs = max(1, round(seconds / epoch_s))

    def _run(self, max_iter):
        params = self.inference.params
        return self.inference.run(
            X=self.X, Y=self.Y, max_iter=max_iter,
            learning_rate=self.traffic["learning_rate"],
            generator=self.generator,
            resume_state=getattr(params, "train_state", None))

    def window(self, epochs=None):
        """Run ``epochs`` (default: the number set-up fixed) more epochs
        in one ``run`` call; returns the window's work and time."""
        epochs = self.window_epochs if epochs is None else epochs
        self.inference.grad_loop.watch(self.traffic["check_steps"])
        t0 = time.perf_counter()
        last = self._run(self.epochs_done + epochs)
        seconds = time.perf_counter() - t0
        self.epochs_done += epochs
        steps = epochs * self.steps_per_epoch
        return {"seconds": seconds, "steps": steps,
                "rows": steps * self.batch, "last_loss": float(last)}

    def trace_window(self):
        return {"epochs": self.traffic["trace_epochs"]}

    def counts(self, out):
        return {"steps": out["steps"], "rows": out["rows"]}

    def model_flops(self, counts):
        return counts["steps"] * self.config.flops_per_step(self.cfg,
                                                            self.batch)

    def k1_launches(self, counts):
        """K1's launches in the window, as (S, N, M, D, L)."""
        return counts["steps"] * self.config.k1_launches_per_step(
            self.cfg, self.batch)

    def fused_shape(self):
        """(M, N, D) of K2 and K3 in a step."""
        return self.cfg["num_inducing"], self.batch, self.cfg["input_dim"]

    def end_to_end(self, out):
        return {"train_rows_per_s": (out["rows"] / out["seconds"], "rows/s")}

    def attempted(self, out):
        return out["steps"]

    def failed(self, out):
        """Steps that failed: all of them when the window ends with a
        loss or a parameter that is not finite (Adam carries a non-finite
        gradient into every later step), else none."""
        finite = math.isfinite(out["last_loss"]) and all(
            bool(torch.isfinite(v).all())
            for v in self.inference.params.trainable_params().values())
        return 0 if finite else out["steps"]

    def release(self):
        """Keep the recorded readings by name; free the program's state."""
        loop = self.inference.grad_loop
        names = self.names

        def named(d):
            return {names[k]: v for k, v in d.items()}
        self.recorded = {
            "losses": [float(x) for x in loop.losses],
            "start": named(loop.start["params"]),
            "adam": named(loop.start["adam"]),
            "generator": loop.start["generator"],
            "first_moment": named(loop.first_moment),
            "after": named(loop.after),
            "first_rows": loop.first_rows}
        del self.inference

    def reference_readings(self, precision):
        """The reference's losses, first gradient norms and change norms
        over the recorded rows, from the recorded state, at
        ``precision``."""
        from ..reference.common import follow_steps
        rec = self.recorded
        g = torch.Generator(self.device)
        if rec["generator"] is not None:
            g.set_state(rec["generator"])
        batches = [(self.X[idx], self.Y[idx],
                    self.reference.draws(self.cfg, self.batch, g))
                   for idx in rec["first_rows"]]
        loss = self.reference.loss_of(self.cfg, self.rows / self.batch)
        losses, grad, change = follow_steps(
            loss, rec["start"], batches, self.traffic["learning_rate"],
            precision, adam=rec["adam"])
        return {"losses": losses, "grad_norms": compare.norms(grad),
                "change_norms": compare.norms(change)}

    def program_readings(self):
        """The program's losses, its first gradient as Adam got it (from
        the first moment before and after the first step) and the change
        of each leaf over the checked steps."""
        from ..reference.common import ADAM_BETAS
        b1 = ADAM_BETAS[0]
        rec = self.recorded
        return {"losses": rec["losses"],
                "grad_norms": compare.norms(
                    {k: (v - b1 * rec["adam"][k][0]) / (1 - b1)
                     for k, v in rec["first_moment"].items()}),
                "change_norms": compare.norms(
                    {k: rec["after"][k] - rec["start"][k]
                     for k in rec["after"]})}

    def rows_valid(self):
        """The recorded batches hold ``batch`` distinct rows each, all
        within the data, and no row twice across them."""
        rows = self.recorded["first_rows"]
        flat = rows.reshape(-1)
        return (tuple(rows.shape) == (self.traffic["check_steps"], self.batch)
                and int(flat.min()) >= 0 and int(flat.max()) < self.rows
                and torch.unique(flat).numel() == flat.numel())

    def check(self, control=None):
        """The numbers of :func:`compare.training_numbers` of the program
        or, with ``control`` (a precision of ``reference.common``), of the
        reference at that precision put in the program's place."""
        want = self.reference_readings("fp32")
        got = self.program_readings() if control is None else \
            self.reference_readings(control)
        self.last_readings = got, want
        numbers = compare.training_numbers(got, want, self.rows)
        if not self.rows_valid():
            numbers["loss_gap"] = math.inf
        return numbers
