"""Inference runners.

Counterpart of ``mxfusion_tpu/inference/inference.py``. ``Inference``
owns an algorithm plus :class:`InferenceParameters`; ``initialize``
binds symbolic shapes from data and allocates parameters; ``run`` builds
the executor and calls it. Zip save/load and the loss-driven run
(training) come later.
"""
import warnings

import numpy as np
import torch

from .inference_parameters import InferenceParameters
from .inference_alg import create_sampling_executor, SamplingAlgorithm
from ..util.inference import discover_shape_constants, init_outcomes
from ..common.exceptions import InferenceError


def _data_shapes(uuids, data):
    return {uuid: tuple(d.shape) if hasattr(d, "shape") else np.shape(d)
            for uuid, d in zip(uuids, data)}


class Inference:
    """Abstract inference runner."""

    def __init__(self, inference_algorithm, constants=None, dtype=None,
                 device=None):
        self._algorithm = inference_algorithm
        self.params = InferenceParameters(constants=constants, dtype=dtype,
                                          device=device)
        self._initialized = False

    @property
    def observed_variables(self):
        return self._algorithm.observed_variables

    @property
    def observed_variable_UUIDs(self):
        return self._algorithm.observed_variable_UUIDs

    @property
    def observed_variable_names(self):
        return self._algorithm.observed_variable_names

    @property
    def inference_algorithm(self):
        return self._algorithm

    @property
    def graphs(self):
        return self._algorithm.graphs

    def _fetch_observed(self, kwargs):
        missing = [n for n in self.observed_variable_names
                   if n not in kwargs]
        if missing:
            raise InferenceError(
                "Missing observed data for variable(s) {}; pass them as "
                "keyword arguments, e.g. run({}=...).".format(
                    missing, missing[0]))
        return [kwargs[n] for n in self.observed_variable_names]

    # ------------------------------------------------------------------
    def initialize(self, generator=None, **kwargs):
        """Bind data shapes and allocate parameters."""
        if self._initialized:
            warnings.warn("Inference already initialized; reinitializing.")
        data = self._fetch_observed(kwargs)
        shape_constants = discover_shape_constants(
            _data_shapes(self.observed_variable_UUIDs, data), self.graphs)
        self.params.constants.update(shape_constants)
        self.params.initialize_params(self.graphs,
                                      self.observed_variable_UUIDs,
                                      generator=generator)
        self._initialized = True

    def run(self, generator=None, **kwargs):
        """Initialize (if needed) and execute the algorithm once."""
        if not isinstance(self._algorithm, SamplingAlgorithm):
            raise NotImplementedError(
                "Inference.run of a loss algorithm is not ported yet: "
                "training comes with the training slice of "
                "mxfusion_tpu_torch.")
        data = self._fetch_observed(kwargs)
        if not self._initialized:
            self.initialize(generator=generator, **kwargs)
        if generator is None:
            generator = torch.Generator(
                device=self.params.device).manual_seed(0)
        executor = create_sampling_executor(self._algorithm, self.params)
        return executor(self.params.trainable_params(),
                        self.params.fixed_params(), data, generator)


class TransferInference(Inference):
    """Inference initialized with parameters carried over from a previous
    inference run (an ``Inference`` or an ``InferenceParameters``).
    ``dtype`` and ``device`` default to those of the first carried-over
    store."""

    def __init__(self, inference_algorithm, infr_params, constants=None,
                 dtype=None, device=None, fix_carryover=True):
        carryover = init_outcomes(infr_params)
        sources = [p.params if isinstance(p, Inference) else p
                   for p in carryover]
        super().__init__(
            inference_algorithm=inference_algorithm, constants=constants,
            dtype=dtype if dtype is not None else sources[0].dtype,
            device=device if device is not None else sources[0].device)
        self._carryover = sources
        self._fix_carryover = fix_carryover

    def initialize(self, generator=None, **kwargs):
        data = self._fetch_observed(kwargs)
        shape_constants = discover_shape_constants(
            _data_shapes(self.observed_variable_UUIDs, data), self.graphs)
        self.params.constants.update(shape_constants)
        carryover = {}
        for source in self._carryover:
            carryover.update(source.param_dict)
            self.params.constants.update(
                {k: v for k, v in source.constants.items()
                 if k not in self.params.constants})
        self.params.initialize_with_carryover_params(
            self.graphs, self.observed_variable_UUIDs, carryover,
            generator=generator, fix_carryover=self._fix_carryover)
        self._initialized = True
