"""Inference algorithms and the executor.

Counterpart of ``mxfusion_tpu/inference/inference_alg.py``. An executor
is a plain function

    executor(trainable, fixed, data_list, generator) -> outputs

that builds the runtime env (constants, bijector-transformed parameters,
observed data, variable ties, each with the leading sample axis) and
calls ``algorithm.compute``. PyTorch runs eagerly, so there is nothing
to compile. The JAX package's PRNG key becomes a ``torch.Generator``
that the :class:`RuntimeContext` holds. The loss executor, minibatch
``rv_scaling`` and the aux writeback come with training.
"""
from abc import ABC, abstractmethod

import torch

from ..common.exceptions import InferenceError
from ..components.variables.variable import VariableType
from ..util.inference import variables_to_UUID


def as_runtime_tensor(value, dtype, device):
    """``value`` as a tensor on ``device``; floating values take
    ``dtype``, other dtypes (integer labels) keep theirs."""
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
    ``torch.Generator`` that random draws take. (The aux writeback of
    training-time state comes with training.)"""

    def __init__(self, generator):
        self.generator = generator

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
    def prepare_executor(self):
        """Collect {uuid: transformation} for every unobserved parameter
        with a bijector, and reset every random variable's generating
        factor to an unscaled log-pdf."""
        excluded = set(self._observed_uuid)
        var_trans = {}
        for g in self.graphs:
            for v in g.variables.values():
                if v.type == VariableType.PARAMETER and \
                        v.transformation is not None and \
                        v.uuid not in excluded:
                    var_trans[v.uuid] = v.transformation
                if v.type == VariableType.RANDVAR:
                    v.factor.log_pdf_scaling = 1.0
        return var_trans

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


def _make_env_builder(algorithm, params):
    """Shared env-construction closure for all executors.

    Applies, in order: constants (python ints stay shape constants;
    scalars get the (1, 1) layout), fixed and trainable parameters
    (bijector-transformed, sample dim added), observed data (sample dim
    added), variable ties. Constants are converted to tensors once, here.
    """
    var_trans = algorithm.prepare_executor()
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
        env = VariableEnv(constants)
        for source in (fixed, trainable):
            for uuid, v in source.items():
                t = var_trans.get(uuid)
                tv = t.transform(v) if t is not None else v
                env[uuid] = torch.unsqueeze(tv, 0)
        for uuid, arr in zip(observed_uuid, data_list):
            env[uuid] = torch.unsqueeze(
                as_runtime_tensor(arr, params.dtype, params.device), 0)
        for tied, to in var_ties.items():
            env[tied] = env[to]
        return env

    return build_env


def create_sampling_executor(algorithm, params):
    """Executor for SamplingAlgorithms: ``executor(trainable, fixed,
    data_list, generator)`` returns compute's output."""
    build_env = _make_env_builder(algorithm, params)

    def executor(trainable, fixed, data_list, generator):
        env = build_env(trainable, fixed, data_list)
        return algorithm.compute(env, RuntimeContext(generator))

    executor.build_env = build_env
    return executor
