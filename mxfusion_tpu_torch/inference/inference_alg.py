"""Inference algorithms and the executor.

Counterpart of ``mxfusion_tpu/inference/inference_alg.py``. An executor
is a plain function

    executor(trainable, fixed, data_list, generator) -> outputs

that builds the runtime env (constants, bijector-transformed parameters,
observed data, variable ties, each with the leading sample axis) and
calls ``algorithm.compute``. PyTorch runs eagerly, so there is nothing
to compile. The JAX package's PRNG key becomes a ``torch.Generator``
that the :class:`RuntimeContext` holds. The loss executor returns
``(loss, loss_for_gradient, aux)``: ``aux`` is the JAX package's
replacement for the reference's ``SET_`` side channel, detached values
that the loops write back into the parameter store after each step.
"""
from abc import ABC, abstractmethod

import numpy as np
import torch

from . import param_memo
from .inference_parameters import MASK_SUFFIX
from ..common.exceptions import InferenceError
from ..common.placement import whole
from ..components.variables.variable import VariableType
from ..util.inference import variables_to_UUID
from ..util.profiling import span


def _scaling_env_key(uuid):
    """Env key carrying a RANDVAR's array rv_scaling (mask/weights)."""
    return uuid + MASK_SUFFIX


def _check_array_scaling(v, arr):
    """Validate an array rv_scaling against the variable's declaration.

    Broadcasting is right-aligned, so a rank-mismatched mask (e.g.
    (N,) against an (N, 1) event) would silently blow the density up to
    (s, N, N) and sum it: require the mask's rank to equal the event
    rank and every statically declared dim to match (or be 1)."""
    from ..modules.module import Module
    if isinstance(v.factor, Module):
        raise InferenceError(
            "array rv_scaling is not supported for module-generated "
            "variable '{}': module bounds scale their already-summed "
            "data term, so only scalars compose correctly."
            .format(v.name or v.uuid))
    shape = tuple(np.shape(arr))
    declared = tuple(v.shape)
    if len(shape) != len(declared):
        raise InferenceError(
            "rv_scaling array for '{}' has rank {} but the variable's "
            "event shape {} has rank {}; masks must match the event "
            "rank exactly (add the trailing singleton dims)."
            .format(v.name or v.uuid, len(shape), declared,
                    len(declared)))
    for d_arr, d_var in zip(shape, declared):
        if isinstance(d_var, int) and d_arr not in (1, d_var):
            raise InferenceError(
                "rv_scaling array for '{}' has shape {} which does not "
                "broadcast against the declared event shape {}."
                .format(v.name or v.uuid, shape, declared))


def as_runtime_tensor(value, dtype, device):
    """``value`` as a tensor on ``device``; floating values take
    ``dtype``, other dtypes (integer labels) keep theirs. A python float
    is made in ``dtype`` directly (through torch's float32 default it
    would lose its float64 digits: 0.01 would become 0.0099999998)."""
    if isinstance(value, float):
        return torch.as_tensor(value, dtype=dtype, device=device)
    t = torch.as_tensor(value, device=device)
    if t.is_floating_point() and t.dtype != dtype:
        t = t.to(dtype)
    return t


class VariableEnv(dict):
    """UUID-keyed runtime env that also accepts Variable keys. Copies of
    an env must stay a ``VariableEnv`` (``VariableEnv(env)``, never
    ``dict(env)``): module algorithms look values up by Variable."""

    @staticmethod
    def _k(key):
        return key.uuid if hasattr(key, "uuid") else key

    def __getitem__(self, key):
        return dict.__getitem__(self, self._k(key))

    def __setitem__(self, key, value):
        dict.__setitem__(self, self._k(key), value)

    def __contains__(self, key):
        return dict.__contains__(self, self._k(key))

    def get(self, key, default=None):
        return dict.get(self, self._k(key), default)


class RuntimeContext:
    """Per-execution state threaded through ``compute``: the
    ``torch.Generator`` that random draws take, and the aux (SET_
    parameter) writeback dict."""

    def __init__(self, generator, data_reduction=None):
        self.generator = generator
        self.aux = {}
        # over data split on a mesh: (value, {uuid: gradient}) of one
        # rank -> the whole data's (parallel.data_parallel); the
        # samplers hand it to hmc.value_and_grad
        self.data_reduction = data_reduction

    def next_generator(self):
        """The generator for the next draw (draws advance its state)."""
        if self.generator is None:
            raise InferenceError(
                "This computation draws random samples but no generator "
                "was provided: pass ctx=RuntimeContext(generator) (or a "
                "generator to the calling API) instead of relying on a "
                "default.")
        return self.generator


class InferenceAlgorithm(ABC):
    """Base class of inference algorithms."""

    def __init__(self, model, observed, extra_graphs=None):
        self._model = model
        self._extra_graphs = extra_graphs if extra_graphs is not None else []
        self._observed = observed
        self._observed_uuid = variables_to_UUID(observed)
        self._observed_names = [v.name for v in observed]

    @property
    def model(self):
        return self._model

    @property
    def graphs(self):
        return [self._model] + self._extra_graphs

    @property
    def observed_variables(self):
        return self._observed

    @property
    def observed_variable_UUIDs(self):
        return self._observed_uuid

    @property
    def observed_variable_names(self):
        return self._observed_names

    def replicate_self(self, model, extra_graphs=None):
        replica = type(self).__new__(type(self))
        replica.__dict__.update(self.__dict__)
        replica._model = model
        replica._extra_graphs = extra_graphs if extra_graphs is not None \
            else []
        return replica

    # ------------------------------------------------------------------
    def prepare_executor(self, rv_scaling=None):
        """Collect {uuid: transformation} for every unobserved parameter
        with a bijector, and set each random variable's generating factor
        to its scalar ``rv_scaling`` (the minibatch correction N/B), 1.0
        where none is given. An array scaling (an observation mask or
        per-point weights) is validated here; the factor then reads it
        from the env under ``log_pdf_scaling_key`` (see
        :func:`_make_env_builder`)."""
        rv_scaling = rv_scaling if rv_scaling is not None else {}
        excluded = set(self._observed_uuid)
        var_trans = {}
        for g in self.graphs:
            for v in g.variables.values():
                if v.type == VariableType.PARAMETER and \
                        v.transformation is not None and \
                        v.uuid not in excluded:
                    var_trans[v.uuid] = v.transformation
                if v.type == VariableType.RANDVAR:
                    s = rv_scaling.get(v.uuid, 1.0)
                    if np.ndim(s) > 0:
                        _check_array_scaling(v, s)
                        v.factor.log_pdf_scaling = 1.0
                        v.factor.log_pdf_scaling_key = \
                            _scaling_env_key(v.uuid)
                    else:
                        v.factor.log_pdf_scaling = float(s)
                        v.factor.log_pdf_scaling_key = None
        return var_trans

    def set_parameter(self, ctx, variable, value):
        """Record a training-time state update (e.g. a cached Cholesky)
        to be written back into the parameter store after the step."""
        ctx.aux[variable.uuid] = value.detach()

    @abstractmethod
    def compute(self, env, ctx):
        """Return ``(loss, loss_for_gradient)`` given a runtime env."""


class SamplingAlgorithm(InferenceAlgorithm):
    """Base for algorithms returning samples instead of a loss;
    ``compute`` returns a dict {uuid: samples} or a tuple in target
    order."""

    #: Per-output-leaf data-axis declaration for chunked serving
    #: (``inference.serving``): a tuple with one tuple of data-axis
    #: indices per flattened output leaf of ONE target — e.g.
    #: ``((1,), (1,))`` for (s, N, D) moments, ``((1,), (1, 2))`` when
    #: the variance is a full (s, N, N) covariance. ``None`` = unknown;
    #: the server then infers axes per leaf (and raises on ambiguity).
    serving_data_axes = None

    def __init__(self, model, observed, num_samples=None,
                 target_variables=None, extra_graphs=None):
        # num_samples=None means "caller never chose a count": it reads
        # as 1 through the normalized property but stays observable via
        # ``num_samples_requested``
        super().__init__(model=model, observed=observed,
                         extra_graphs=extra_graphs)
        self.num_samples = num_samples
        self.target_variables = variables_to_UUID(target_variables) \
            if target_variables is not None else None

    @property
    def num_samples(self):
        """Sample count, normalized: an UNSET request (None) reads as 1."""
        return 1 if self._num_samples is None else self._num_samples

    @num_samples.setter
    def num_samples(self, value):
        self._num_samples = value

    @property
    def num_samples_requested(self):
        """The raw requested count — ``None`` when the caller never set
        one."""
        return self._num_samples


def _env_parameter(v, t):
    """A parameter's env entry: ``v`` (a parameter placed over a mesh
    axis, whole: every rank's block, all-gathered) under its transform
    ``t``, with the sample axis added."""
    v = whole(v)
    tv = t.transform(v) if t is not None else v
    return torch.unsqueeze(tv, 0)


def _make_env_builder(algorithm, params, rv_scaling=None):
    """Shared env-construction closure for all executors.

    Applies, in order: constants (python ints stay shape constants;
    scalars get the (1, 1) layout), fixed and trainable parameters
    (a DTensor gathered whole, bijector-transformed, sample dim added;
    inside a ``param_memo`` scope, the entry built for that tensor at its
    version), observed data (sample dim added), variable ties. Constants
    are converted to tensors once, here.
    """
    var_trans = algorithm.prepare_executor(rv_scaling=rv_scaling)
    # an array rv_scaling (observation mask) joins the fixed parameters
    # of every call as a tensor on the run's device, so it reaches the
    # factor through the env like any other input; the store never holds
    # it, and a ``fixed`` entry under its key replaces it for that call
    masks = {_scaling_env_key(uuid): params.as_tensor(s)
             for uuid, s in (rv_scaling or {}).items() if np.ndim(s) > 0}
    for g in algorithm.graphs:
        for m in g.modules.values():
            var_trans.update(m.collect_internal_transformations())
    constants = {}
    for uuid, v in params.constants.items():
        if hasattr(v, "shape") or isinstance(v, float):
            arr = as_runtime_tensor(v, params.dtype, params.device)
            if arr.ndim == 0:
                # scalar constants get an event dim so the sample axis
                # stays unambiguous: (1, 1), not (1,)
                arr = arr.reshape(1)
            constants[uuid] = torch.unsqueeze(arr, 0)
        else:
            constants[uuid] = v
    observed_uuid = list(algorithm.observed_variable_UUIDs)
    var_ties = {}
    for g in algorithm.graphs:
        var_ties.update(g.var_ties)

    def build_env(trainable, fixed, data_list):
        with span("executor.env"):
            env = VariableEnv(constants)
            for source in ({**masks, **fixed}, trainable):
                for uuid, v in source.items():
                    # inside a predictor's memo scope a parameter's entry
                    # is kept while its tensor is unchanged
                    t = var_trans.get(uuid)
                    env[uuid] = param_memo.env_value(
                        uuid, v, t, lambda: _env_parameter(v, t))
            for uuid, arr in zip(observed_uuid, data_list):
                env[uuid] = torch.unsqueeze(
                    as_runtime_tensor(arr, params.dtype, params.device), 0)
            for tied, to in var_ties.items():
                env[tied] = env[to]
            return env

    return build_env


def create_executor(algorithm, params, rv_scaling=None, remat=False):
    """The objective of a loss algorithm: ``executor(trainable, fixed,
    data_list, generator) -> (loss, loss_for_gradient, aux)``, where
    ``trainable``/``fixed`` are {uuid: unconstrained tensor} dicts and
    ``data_list`` is the observed data in
    ``algorithm.observed_variable_UUIDs`` order. Gradients flow from
    ``loss_for_gradient`` to the tensors of ``trainable``.

    ``remat=True`` runs the objective under
    ``torch.utils.checkpoint.checkpoint`` (``use_reentrant=False``): its
    activations are recomputed in the backward pass instead of kept,
    trading operations for device memory, as ``jax.checkpoint`` does.
    The recompute draws the forward's random numbers again: checkpoint
    restores the global RNGs only, so the executor saves the generator's
    state before the forward, restores it before the recompute, and
    sets the generator back to its post-forward state after it, so the
    next step draws what a run without ``remat`` draws."""
    build_env = _make_env_builder(algorithm, params, rv_scaling=rv_scaling)

    def objective(trainable, fixed, data_list, generator):
        env = build_env(trainable, fixed, data_list)
        ctx = RuntimeContext(generator)
        result = algorithm.compute(env, ctx)
        if isinstance(result, tuple) and len(result) == 2:
            loss, loss_for_grad = result
        else:
            loss = loss_for_grad = result
        return loss, loss_for_grad, ctx.aux

    executor = _rematerialized(objective) if remat else objective
    executor.build_env = build_env
    # what parallel.data_parallel needs to rebuild it for one rank's rows
    executor.algorithm = algorithm
    executor.params = params
    executor.rv_scaling = rv_scaling
    executor.remat = remat
    return executor


def _rematerialized(objective):
    """``objective`` under a non-reentrant checkpoint, its generator
    replayed in the recompute (see :func:`create_executor`)."""
    from torch.utils import checkpoint

    def executor(trainable, fixed, data_list, generator):
        states = {}

        def run(trainable, fixed, data_list):
            if generator is None:
                return objective(trainable, fixed, data_list, generator)
            if "after" in states:          # the backward's recompute
                generator.set_state(states["before"])
                out = objective(trainable, fixed, data_list, generator)
                generator.set_state(states["after"])
                return out
            states["before"] = generator.get_state()
            out = objective(trainable, fixed, data_list, generator)
            states["after"] = generator.get_state()
            return out

        # the whole objective is recomputed, so the generator is set
        # back after its last draw
        with checkpoint.set_checkpoint_early_stop(False):
            return checkpoint.checkpoint(run, trainable, fixed, data_list,
                                         use_reentrant=False)

    return executor


def create_sampling_executor(algorithm, params, rv_scaling=None,
                             data_sharding=None):
    """Executor for SamplingAlgorithms: ``executor(trainable, fixed,
    data_list, generator)`` returns compute's output.

    ``rv_scaling`` rescales the generating factors' log-pdfs exactly as
    in :func:`create_executor`: a minibatch sampler (SGLD) passes the
    N/B likelihood correction through it. ``data_sharding``: one
    ``parallel.Sharding`` per observed array, the placement of the data
    the executor is then called with, each array's part on this rank
    (what ``parallel.shard_data`` returns, under the placements that
    ``parallel.data_shardings`` gives); the chains then equal the
    unsharded ones (``parallel.data_parallel.sharded_sampling_executor``)."""
    if data_sharding is not None:
        from ..parallel.data_parallel import sharded_sampling_executor
        return sharded_sampling_executor(algorithm, params, rv_scaling,
                                         data_sharding)
    return sampling_executor(algorithm, params, rv_scaling)


def sampling_executor(algorithm, params, rv_scaling=None,
                      data_reduction=None):
    """:func:`create_sampling_executor` over whole data; the compute's
    ``RuntimeContext`` carries ``data_reduction`` (see there)."""
    build_env = _make_env_builder(algorithm, params, rv_scaling=rv_scaling)

    def executor(trainable, fixed, data_list, generator):
        env = build_env(trainable, fixed, data_list)
        return algorithm.compute(env, RuntimeContext(generator,
                                                     data_reduction))

    executor.build_env = build_env
    return executor
