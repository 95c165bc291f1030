"""Data-parallel gradient loops and samplers over a mesh.

Counterpart of ``mxfusion_tpu/parallel/data_parallel.py``. JAX's loops
keep the one-device objective: data is sharded, parameters replicated,
and GSPMD partitions the very same program. The port keeps the same
semantics (the loss, its gradient and the trajectory equal the
single-process run's within float reassociation) by another mechanism,
one process per device:

* Every rank holds the same parameters and draws from a generator of the
  same seed, so the draws of global latents agree.
* When the objective splits over data rows, each rank evaluates its
  block of the rows with the data-row variables' log-pdf scaling
  multiplied by the data-axis size n, and the loss and gradients are
  ``all_reduce``-averaged: the mean over ranks of prior + n · (a block's
  data term) is prior + the whole data term (``make_shard_map_step``'s
  recipe in JAX). The model's symbolic data dim is bound to the block's
  rows for that.
* Otherwise every rank evaluates the whole data, replicated: JAX's
  ``gather_data`` semantics, exact, with no collective in the step.
  That is so when a factor over the rows couples them or may (it says
  ``row_separable = False``: ``GPRegression``, ``SparseGPRegression``,
  the GP and state-space distributions, the reducing and reshaping
  operators, and a user's ``Function`` or ``NNFunction`` unless the
  function declares ``row_separable = True``), when a data array's
  leading dim is a fixed number rather than a symbolic dim the loop can
  rebind, when a parameter has a row per data point, or under an array
  ``rv_scaling`` (a mask has the data's rows). Module caches are then
  those of the whole data; in the split case the ported modules write
  none.

A local latent drawn per row (an amortized VAE's z) is drawn, on each
rank, for that rank's rows: the draws differ from a one-process run's in
value, not in distribution.
"""
import numpy as np
import torch
import torch.distributed as dist

from .mesh import (DATA_AXIS, all_gather, axis_size, batch_sharding,
                   data_shardings, replicate_tree)
from ..common.placement import is_sharded
from ..components.variables.variable import Variable, VariableType
from ..inference.batch_loop import BatchInferenceLoop
from ..inference.grad_loop import make_optimizer
from ..inference.minibatch_loop import MinibatchInferenceLoop


def _row_split(algorithm, sharded_uuids, rv_scaling):
    """``(symbols, row_randvars)`` when the objective splits over the
    data rows: the uuids of the symbolic data dims, and of the random
    variables over them, whose log-pdf scaling the split multiplies.
    None when it does not (see the module docstring)."""
    if any(np.ndim(s) > 0 for s in (rv_scaling or {}).values()):
        return None
    variables = {u: v for g in algorithm.graphs
                 for u, v in g.variables.items()}
    observed = set(algorithm.observed_variable_UUIDs)
    symbols = set()
    for u in sharded_uuids:
        v = variables.get(u)
        if v is None or not v.shape or not isinstance(v.shape[0], Variable):
            return None
        symbols.add(v.shape[0].uuid)

    def on_rows(v):
        return bool(v.shape) and isinstance(v.shape[0], Variable) and \
            v.shape[0].uuid in symbols

    for u in observed - set(sharded_uuids):
        if u in variables and on_rows(variables[u]):
            return None  # a replicated array over the sharded rows
    rows = set()   # a posterior's variables share their model's uuids
    for g in algorithm.graphs:
        for f in g.ordered_factors:
            edges = [v for _, v in list(f.inputs) + list(f.outputs)]
            if any(on_rows(v) for v in edges) and \
                    not getattr(f, "row_separable", False):
                return None
        for v in g.variables.values():
            if not on_rows(v):
                continue
            if v.type == VariableType.PARAMETER and v.uuid not in observed:
                return None
            if v.type == VariableType.RANDVAR:
                rows.add(v.uuid)
    return symbols, rows


def _all_reduce_mean(tensors, n, group):
    """Average ``tensors`` over the group in place, one collective per
    dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= n
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def _tensor(d, device):
    return torch.as_tensor(d if torch.is_tensor(d) else np.asarray(d),
                           device=device)


def _with_constants(params, constants, build):
    """``build()`` with ``params.constants`` updated by ``constants``,
    restored afterwards (an executor reads them when it is built)."""
    old = {u: params.constants[u] for u in constants
           if u in params.constants}
    params.constants.update(constants)
    try:
        return build()
    finally:
        for u in constants:
            params.constants.pop(u, None)
        params.constants.update(old)


class DataParallelPlan:
    """How one objective is evaluated over data spread on a mesh (see the
    module docstring). ``factory(algorithm, params, rv_scaling,
    data_reduction)`` builds an executor: ``create_executor`` for the
    loops (which reduce through :meth:`reduce` and ignore
    ``data_reduction``), the sampling executor for the samplers, whose
    ``hmc.value_and_grad`` reduces through :meth:`reduce_values` where
    the rows split and through nothing otherwise. ``shardings`` holds
    one ``Sharding`` per observed array, and ``rows`` is the data's
    global row count. ``split=False`` keeps the whole data on every rank
    even where the objective splits.

    ``executor`` is the one a rank calls, ``gather`` says whether it
    takes the whole data, ``[lo, hi)`` is this rank's block of the rows
    otherwise, and :meth:`reduce` averages a step's loss and gradients
    over the data axis."""

    def __init__(self, factory, algorithm, params, shardings, rows,
                 rv_scaling=None, split=True):
        self.shardings = list(shardings)
        # the rows split over the first sharding that shards (else the
        # first, a replicated one: an axis of one block)
        self.sharding = next((s for s in self.shardings if s.is_shard),
                             self.shardings[0])
        self.n = self.sharding.n_shards
        self._algorithm = algorithm
        self._rv_scaling = rv_scaling
        sharded = [u for u, s in zip(algorithm.observed_variable_UUIDs,
                                     self.shardings) if s.is_shard]
        plan = _row_split(algorithm, sharded, rv_scaling) \
            if split and sharded and rows % self.n == 0 else None
        self.gather = plan is None
        if self.gather:
            self.lo, self.hi = 0, rows
            self.executor = factory(algorithm, params, rv_scaling, None)
            return
        self.lo, self.hi = self.sharding.block(rows)
        symbols, row_vars = plan
        scaling = dict(rv_scaling or {})
        for u in row_vars:
            scaling[u] = float(scaling.get(u, 1.0)) * self.n
        self.executor = _with_constants(
            params, {u: rows // self.n for u in symbols},
            lambda: factory(algorithm, params, scaling, self.reduce_values))

    def local(self, data, device):
        """What this rank evaluates of each whole array (the batch loop's
        data): its block of a sharded array when the objective splits,
        all of it otherwise."""
        if self.gather:
            return [_tensor(d, device) for d in data]
        return [self.resident(d, s, len(d), device)
                for d, s in zip(data, self.shardings)]

    def resident(self, d, sharding, rows, device):
        """This rank's block of ``d`` when it is sharded, else all of it
        (the device loop's resident data)."""
        if sharding.is_shard:
            lo, hi = sharding.block(rows)
            d = d[lo:hi]
        return _tensor(d, device)

    def all_gather(self, t):
        return all_gather(t, self.sharding.group, self.n)

    def reduce(self, loss, leaves):
        """The loss averaged over the data axis, and the ``.grad`` of each
        leaf too (in place). In the gather case every rank computed the
        same values, and nothing is exchanged."""
        if self.gather:
            return loss
        grads = [p.grad for p in leaves if p.grad is not None]
        _all_reduce_mean(grads + [loss], self.n, self.sharding.group)
        return loss

    def reduce_values(self, out, grads):
        """A potential's value and its gradients ({uuid: tensor}) on this
        rank's rows -> the whole data's, averaged over the data axis in
        place (the split case's ``data_reduction``)."""
        _all_reduce_mean([out] + list(grads.values()), self.n,
                         self.sharding.group)
        return out, grads

    def finish(self):
        """Restore the factors' log-pdf scaling to the unsplit one
        (building a rank's executor re-scaled them)."""
        if not self.gather:
            self._algorithm.prepare_executor(rv_scaling=self._rv_scaling)


def sharded_sampling_executor(algorithm, params, rv_scaling, shardings):
    """``create_sampling_executor(data_sharding=shardings)``: an executor
    called with each observed array's part on this rank (``shard_data``'s
    output). Where the objective splits, each potential is evaluated on
    this rank's rows and its value and gradient are all-reduced
    (``hmc.value_and_grad``, through the ``RuntimeContext``'s
    ``data_reduction``), so the chains equal the unsharded ones;
    otherwise the rows are all-gathered and the sampler runs replicated.
    A sampler that evaluates its potential elsewhere than in
    ``value_and_grad`` (SGLD on minibatches) says so by its
    ``reduces_over_data`` and takes the gathered rows."""
    from ..inference.inference_alg import sampling_executor
    shardings = list(shardings)

    def executor(trainable, fixed, data_list, generator):
        rows = next((d.shape[0] * s.n_shards
                     for d, s in zip(data_list, shardings) if s.is_shard), 0)
        plan = DataParallelPlan(
            sampling_executor, algorithm, params, shardings, rows, rv_scaling,
            split=getattr(algorithm, "reduces_over_data", False))
        if plan.gather:
            data_list = [all_gather(d, s.group, s.n_shards) if s.is_shard
                         else d for d, s in zip(data_list, shardings)]
        try:
            return plan.executor(trainable, fixed, data_list, generator)
        finally:
            plan.finish()
    return executor


class DataParallelBatchLoop(BatchInferenceLoop):
    """Full-batch loop with the data sharded over a mesh."""

    def __init__(self, mesh, axis_name=DATA_AXIS, steps_per_call=1,
                 metrics_callback=None):
        super().__init__(steps_per_call=steps_per_call,
                         metrics_callback=metrics_callback)
        self.mesh = mesh
        self.axis_name = axis_name

    def run(self, executor, params, data, **kwargs):
        """``data_sharding``, when given, overrides the per-array choice
        of ``shard_data`` (shard what the axis divides, replicate the
        rest)."""
        if kwargs.get("data_sharding") is None:
            kwargs["data_sharding"] = data_shardings(self.mesh, data,
                                                     self.axis_name)
        params.update_params(replicate_tree(
            self.mesh, dict(params.param_dict)))
        return super().run(executor, params, data, **kwargs)


class DataParallelMinibatchLoop(MinibatchInferenceLoop):
    """Minibatch loop whose batches are split over the mesh.

    The global batch of size B is split across ranks (B must divide by
    the data-axis size); every rank shuffles alike, takes its block of
    each batch, and ``rv_scaling`` stays N/B as in the one-process case.
    """

    def __init__(self, mesh, batch_size=100, rv_scaling=None,
                 axis_name=DATA_AXIS, batches_per_call=1,
                 metrics_callback=None):
        super().__init__(batch_size=batch_size, rv_scaling=rv_scaling,
                         batches_per_call=batches_per_call,
                         metrics_callback=metrics_callback)
        self.mesh = mesh
        self.axis_name = axis_name

    def run(self, executor, params, data, **kwargs):
        # the loop clamps the batch to min(batch_size, N): validate that
        # value here, where the error can name the fix
        n_shards = axis_size(self.mesh, self.axis_name)
        N = int(np.shape(data[0])[0]) if data else 0
        B = min(self.batch_size, N)
        if B % n_shards:
            raise ValueError(
                "effective batch size min(batch_size={}, N={}) = {} "
                "must be divisible by the '{}' mesh axis size ({}) "
                "for data-parallel minibatching.".format(
                    self.batch_size, N, B, self.axis_name, n_shards))
        params.update_params(replicate_tree(
            self.mesh, dict(params.param_dict)))
        kwargs["data_sharding"] = [
            batch_sharding(self.mesh, np.ndim(d), self.axis_name)
            for d in data]
        return super().run(executor, params, data, **kwargs)


def _rank_generator(generator, index):
    """A generator for rank ``index``: seeded from one draw of
    ``generator`` (which every rank advances alike) plus the index, as
    JAX folds the shard index into the key."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(seed + index)


def _gathered(data, mesh, axis_name):
    """Every rank's rows of each array (all sharded, as the shard_map
    step takes them), all-gathered."""
    n = axis_size(mesh, axis_name)
    group = mesh.get_group(axis_name)
    return [all_gather(d, group, n) for d in data]


class _Placed:
    """How a parameter placed over a mesh axis (a DTensor) is laid out:
    ``view(local)`` is the DTensor over ``local``, this rank's block,
    differentiable so that the block's gradient reaches ``local``."""

    def __init__(self, dtensor):
        self.mesh = dtensor.device_mesh
        self.placements = dtensor.placements
        self.shape = dtensor.shape
        self.stride = dtensor.stride()

    def view(self, local):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=self.shape,
                                  stride=self.stride)


class _ShardMapOptimizer:
    """``init(trainable)`` -> the optimizer state that
    ``make_shard_map_step``'s step takes: a ``torch.optim`` optimizer
    over leaf copies of ``trainable`` (optax's ``opt.init``). A DTensor
    entry (``parallel.device_put`` over the model axis) keeps its
    placement: its leaf is a copy of this rank's block, so the
    optimizer's moments have the block's shape, and ``placed`` records
    how to view the leaf as the DTensor again."""

    def __init__(self, optimizer, learning_rate):
        self.optimizer = optimizer
        self.learning_rate = learning_rate

    def init(self, trainable):
        placed = {k: _Placed(v) for k, v in trainable.items()
                  if is_sharded(v)}
        leaves = {k: (v.to_local() if k in placed else v)
                  .detach().clone().requires_grad_(True)
                  for k, v in trainable.items()}
        opt = make_optimizer(self.optimizer, self.learning_rate,
                             list(leaves.values()))
        opt.leaves = leaves
        opt.placed = placed
        # what the step hands back: the leaves, a placed one viewed as
        # its DTensor (sharing the leaf's storage)
        opt.held = {k: placed[k].view(v.detach()) if k in placed else v
                    for k, v in leaves.items()}
        return opt


def make_shard_map_step(executor, mesh, optimizer, learning_rate,
                        axis_name=DATA_AXIS, gather_data=False):
    """An explicit data-parallel training step; returns ``(step, opt)``
    with ``opt.init(trainable) -> opt_state``, and
    ``step(trainable, fixed, opt_state, generator, data) -> (trainable,
    opt_state, loss, aux)`` on this rank's shards ``data`` (from
    ``shard_data``).

    Each rank runs the objective on its own rows; the loss and gradients
    are averaged over the data axis and the update runs replicated. A
    ``trainable`` entry placed over the model axis (a DTensor from
    ``parallel.device_put``) stays placed: the objective gathers it whole
    (and hands its block's gradient back), its gradient is averaged over
    the data axis through its block, the optimizer updates the block and
    its moments, of the block's shape, and the step returns it as the
    DTensor, as JAX returns a sharded array. For
    an objective whose likelihood is a sum over the data (SVI, SVGP),
    build the executor with ``rv_scaling`` multiplied by the axis size
    and the data dim bound to the local rows, so the ranks' losses
    average to prior + the whole likelihood. Each rank draws from a
    generator offset by its index, as JAX folds the shard index into the
    key: the ranks' draws are independent, a valid estimator of the
    same objective.

    ``gather_data=True`` is for objectives that do not split over the
    data (the exact GP's one N × N Cholesky): each rank all-gathers the
    rows and computes the whole objective replicated, with the caller's
    generator unchanged, so no scaling and identical ranks; module
    caches then come back as ``aux``, the whole data's. Under
    ``gather_data=False`` a rank's caches are functions of its rows, and
    no average of them is one (the mean of Cholesky factors is not a
    Cholesky factor): ``aux`` is empty, and one
    :func:`make_cache_refresh_step` call afterwards leaves the modules
    ready to predict."""
    opt = _ShardMapOptimizer(optimizer, learning_rate)
    n = axis_size(mesh, axis_name)
    group = mesh.get_group(axis_name)
    index = mesh.get_local_rank(axis_name)

    def step(trainable, fixed, opt_state, generator, data):
        leaves, placed = opt_state.leaves, opt_state.placed
        with torch.no_grad():
            for k, v in trainable.items():
                if is_sharded(v) != (k in placed):
                    raise ValueError(
                        "trainable entry {} is {}placed over a mesh axis, "
                        "but opt.init took it {}placed: place it alike for "
                        "both.".format(k, "" if k not in placed else "not ",
                                       "" if k in placed else "not "))
                if v is not opt_state.held[k]:
                    leaves[k].copy_(v.to_local() if k in placed else v)
        if gather_data:
            data = _gathered(data, mesh, axis_name)
        else:
            generator = _rank_generator(generator, index)
        opt_state.zero_grad(set_to_none=True)
        inputs = {k: placed[k].view(v) if k in placed else v
                  for k, v in leaves.items()}
        loss, loss_for_grad, aux = executor(inputs, fixed, data, generator)
        loss_for_grad.backward()
        loss = loss.detach()
        grads = [p.grad for p in leaves.values() if p.grad is not None]
        _all_reduce_mean(grads + [loss], n, group)
        opt_state.step()
        if not gather_data:
            aux = {}  # a rank's caches are not reducible (see above)
        return dict(opt_state.held), opt_state, loss, aux

    return step, opt


def make_cache_refresh_step(executor, mesh, axis_name=DATA_AXIS):
    """One forward pass over the whole (all-gathered) data that returns
    the module caches after a ``make_shard_map_step(gather_data=False)``
    training: ``step(trainable, fixed, generator, data) -> (loss, aux)``,
    ``data`` this rank's shards. The caches are equal on every rank;
    write them into the parameters and the modules predict::

        step = make_cache_refresh_step(executor, mesh)
        loss, aux = step(trainable, fixed, generator, data)
        infr.params.update_params(aux)
        infr.params.fixed.update(aux.keys())

    The executor's symbolic data dim must fit the whole data (bind it
    so, or build a second executor). If the training executor carried
    the axis-size factor in ``rv_scaling``, the returned loss carries it
    too: use it as a diagnostic only."""

    def step(trainable, fixed, generator, data):
        full = _gathered(data, mesh, axis_name)
        with torch.no_grad():
            loss, _, aux = executor(trainable, fixed, full, generator)
        return loss, aux

    return step

