"""Abstract gradient loop and the loops' resume state.

Counterpart of ``mxfusion_tpu/inference/grad_loop.py``. The JAX loops
thread (trainable, optimizer state, key) through a jitted step; here the
trainable parameters are leaf tensors that a ``torch.optim`` optimizer
updates in place, and the key is a ``torch.Generator``.
:func:`make_optimizer` lives here (in JAX: ``batch_loop.py``), beside
the loop code that calls it.
"""
import copy
import json
from abc import ABC, abstractmethod

import torch

from ..util.profiling import span


class TrainState:
    """Loop-internal state for a deterministic resume: the step (the
    epoch, for the minibatch loops), the generator's state, the
    optimizer's ``state_dict`` and its class name. A loop resumed from it
    rebuilds the same optimizer (same ``optimizer`` and
    ``learning_rate``) and loads them; :meth:`restore` raises, before
    the first step, where the state does not fit that optimizer."""

    def __init__(self, step=0, generator_state=None, opt_state=None,
                 optimizer=None):
        self.step = step
        self.generator_state = generator_state
        self.opt_state = opt_state
        self.optimizer = optimizer

    def restore(self, opt, generator):
        """Load the optimizer state into ``opt`` and the generator state
        into ``generator``. Raises ``ValueError`` when ``opt`` is another
        optimizer than the one checkpointed (class or hyperparameters)
        or a state tensor's shape differs from its parameter's."""
        if self.optimizer is not None and \
                self.optimizer != type(opt).__name__:
            raise ValueError(
                "TrainState was checkpointed with the {} optimizer but the "
                "loop's optimizer is {}: resume must rebuild the same "
                "optimizer (same optimizer= and learning_rate=) it was "
                "checkpointed with.".format(self.optimizer,
                                            type(opt).__name__))
        if self.opt_state is not None:
            saved = [_hyperparameters(g)
                     for g in self.opt_state["param_groups"]]
            fresh = [_hyperparameters(g) for g in opt.param_groups]
            if saved != fresh:
                raise ValueError(
                    "TrainState's optimizer param groups {} differ from the "
                    "loop's optimizer's {}: resume must rebuild the same "
                    "optimizer (same optimizer= and learning_rate=) it was "
                    "checkpointed with.".format(saved, fresh))
            params = [p for g in opt.param_groups for p in g["params"]]
            for i, state in self.opt_state["state"].items():
                for name, value in state.items():
                    if not isinstance(value, torch.Tensor) or \
                            value.ndim == 0:
                        continue
                    if tuple(value.shape) != tuple(params[i].shape):
                        raise ValueError(
                            "TrainState optimizer state {!r} of parameter "
                            "{} has shape {} but the parameter has shape "
                            "{}: the checkpoint belongs to a different "
                            "model/optimizer configuration.".format(
                                name, i, tuple(value.shape),
                                tuple(params[i].shape)))
            opt.load_state_dict(self.opt_state)
        if self.generator_state is not None:
            generator.set_state(self.generator_state)


def _hyperparameters(group):
    """A param group's settings and parameter count, as JSON would hold
    them (a checkpoint stores them so)."""
    settings = {k: v for k, v in group.items() if k != "params"}
    settings["n_params"] = len(group["params"])
    return json.loads(json.dumps(settings, sort_keys=True))


def make_optimizer(optimizer, learning_rate, params):
    """A ``torch.optim`` optimizer over ``params``, set up as the optax
    optimizer of the same name: ``adam`` (eps outside the square root,
    as in optax), ``sgd``, ``adagrad`` (initial accumulator 0.1, eps
    1e-7), ``rmsprop`` (decay 0.9, eps 1e-8) and ``adamw`` (weight decay
    1e-4). ``optimizer`` may also be a callable ``(params, lr) ->
    torch.optim.Optimizer``."""
    opts = {
        "adam": lambda p, lr: torch.optim.Adam(p, lr=lr),
        "sgd": lambda p, lr: torch.optim.SGD(p, lr=lr),
        "adagrad": lambda p, lr: torch.optim.Adagrad(
            p, lr=lr, initial_accumulator_value=0.1, eps=1e-7),
        "rmsprop": lambda p, lr: torch.optim.RMSprop(
            p, lr=lr, alpha=0.9, eps=1e-8),
        "adamw": lambda p, lr: torch.optim.AdamW(p, lr=lr,
                                                 weight_decay=1e-4),
    }
    if callable(optimizer):
        return optimizer(params, learning_rate)
    if optimizer not in opts:
        raise ValueError("Unknown optimizer {}.".format(optimizer))
    return opts[optimizer](params, learning_rate)


def _global_norm(tensors):
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


class GradLoop(ABC):

    #: the data-parallel plan of the running ``run`` (``data_sharding=``),
    #: else None: it supplies the executor of this rank's rows and
    #: all-reduces each step's loss and gradients
    _plan = None

    def _data_parallel(self, executor, data_sharding, rows):
        """The executor a run over ``rows`` data rows steps: with
        ``data_sharding`` (a list of ``parallel.Sharding``, one per
        observed array), that of a :class:`~..parallel.data_parallel.
        DataParallelPlan`, which this loop keeps until the run ends."""
        self._plan = None
        if data_sharding is None:
            return executor
        from ..parallel.data_parallel import DataParallelPlan
        from .inference_alg import create_executor

        def factory(algorithm, params, rv_scaling, _data_reduction):
            return create_executor(algorithm, params, rv_scaling,
                                   remat=executor.remat)
        self._plan = DataParallelPlan(
            factory, executor.algorithm, executor.params, data_sharding,
            rows, executor.rv_scaling)
        return self._plan.executor

    def _full_batch(self, executor, data, data_sharding, device):
        """The executor and the data tensors of a full-batch run: this
        rank's under ``data_sharding`` (:meth:`_data_parallel`), all of
        them otherwise."""
        executor = self._data_parallel(
            executor, data_sharding, int(data[0].shape[0]) if data else 0)
        if self._plan is not None:
            return executor, self._plan.local(data, device)
        return executor, [torch.as_tensor(d, device=device) for d in data]

    def _finish(self):
        """End the run's data-parallel plan (restores the executor's
        log-pdf scaling)."""
        if self._plan is not None:
            self._plan.finish()
            self._plan = None

    def _reduce(self, loss, leaves):
        """Under a data-parallel plan, ``loss`` and the ``.grad`` of
        ``leaves`` averaged over the data axis (in place for the
        gradients); ``loss`` as it is otherwise."""
        if self._plan is None:
            return loss
        return self._plan.reduce(loss, leaves)

    @staticmethod
    def _start(params, optimizer, learning_rate, generator, resume_state):
        """Trainable leaf tensors (copies of the store's), the fixed
        ones, the optimizer over the first, the generator and the first
        step, restored from ``resume_state`` when one is given."""
        trainable = {k: v.detach().clone().requires_grad_(True)
                     for k, v in params.trainable_params().items()}
        fixed = dict(params.fixed_params())
        opt = make_optimizer(optimizer, learning_rate,
                             list(trainable.values()))
        if generator is None:
            generator = torch.Generator(
                device=params.device).manual_seed(0)
        start = 0
        if resume_state is not None:
            resume_state.restore(opt, generator)
            start = int(resume_state.step or 0)
        return trainable, fixed, opt, generator, start

    def _step(self, executor, opt, trainable, fixed, batch, generator,
              grad_norm=False):
        """One optimizer step. The loss is the one at the parameters
        before the update, as in the JAX loops. Returns (loss, aux,
        gradient norm or None); ``aux`` is merged into ``fixed`` by the
        caller."""
        opt.zero_grad(set_to_none=True)
        loss, loss_for_grad, aux = executor(trainable, fixed, batch,
                                            generator)
        with span("loop.backward"):
            loss_for_grad.backward()
        loss = self._reduce(loss.detach(), trainable.values())
        gnorm = None
        if grad_norm:
            gnorm = _global_norm([p.grad for p in trainable.values()
                                  if p.grad is not None])
        with span("loop.optimizer"):
            opt.step()
        return loss.detach(), aux, gnorm

    @staticmethod
    def _sync_live_state(params, trainable, fixed, opt=None, generator=None,
                         step=None):
        """Write the loop's current trainable/fixed state back into the
        parameter store (copies, so later steps do not change it), and,
        when the optimizer is given, publish a :class:`TrainState` as
        ``params.train_state`` (the loops do so after their last step
        too, callback or not)."""
        params.update_params({k: v.detach().clone()
                              for k, v in trainable.items()})
        params.update_params(fixed)
        if opt is not None:
            params.train_state = TrainState(
                step=step, generator_state=generator.get_state(),
                opt_state=copy.deepcopy(opt.state_dict()),
                optimizer=type(opt).__name__)

    @abstractmethod
    def run(self, executor, params, data, optimizer="adam",
            learning_rate=1e-3, max_iter=1000, generator=None,
            verbose=False, callback=None, data_sharding=None,
            resume_state=None):
        """Run the optimization loop; returns the final loss."""
