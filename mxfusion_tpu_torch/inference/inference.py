"""Inference runners.

Counterpart of ``mxfusion_tpu/inference/inference.py``. ``Inference``
owns an algorithm plus :class:`InferenceParameters`; ``initialize``
binds symbolic shapes from data and allocates parameters; ``run`` builds
the executor and calls it once. ``save``/``load`` write and read the
JAX package's zip (graph skeletons as JSON, parameter npz, constants,
configuration), restored onto freshly built graphs by reconciliation, so
a zip saved by either package loads in the other.
"""
import json
import warnings
import zipfile

import numpy as np
import torch

from .inference_parameters import InferenceParameters
from .inference_alg import (create_executor, create_sampling_executor,
                            SamplingAlgorithm)
from ..models.factor_graph import FactorGraph
from ..util.inference import discover_shape_constants, init_outcomes
from ..util.serialization import (
    SERIALIZATION_VERSION, FILENAMES, make_numpy_zip_bytes,
    read_numpy_zip_bytes)
from ..common.exceptions import InferenceError, SerializationError
from ..common.placement import whole
from ..__version__ import __version__


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

    def print_params(self):
        """One line per parameter: its name, UUID prefix and value."""
        out = []
        for uuid, arr in self.params.param_dict.items():
            name = None
            for g in self.graphs:
                if uuid in g.components:
                    name = g.components[uuid].name
                    break
            out.append("{} ({}): {}".format(
                name, uuid[:8], whole(arr).detach().cpu().numpy()))
        return "\n".join(out)

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
        """Initialize (if needed) and execute the algorithm once. A loss
        algorithm returns ``(loss, loss_for_gradient, aux)`` and its aux
        (SET_) values persist into the parameter store as fixed
        entries."""
        data = self._fetch_observed(kwargs)
        if not self._initialized:
            self.initialize(generator=generator, **kwargs)
        if generator is None:
            generator = torch.Generator(
                device=self.params.device).manual_seed(0)
        if isinstance(self._algorithm, SamplingAlgorithm):
            executor = create_sampling_executor(self._algorithm,
                                                self.params)
            return executor(self.params.trainable_params(),
                            self.params.fixed_params(), data, generator)
        executor = create_executor(self._algorithm, self.params)
        loss, loss_for_grad, aux = executor(
            self.params.trainable_params(), self.params.fixed_params(),
            data, generator)
        if aux:
            self.params.update_params(aux)
            self.params.fixed.update(aux.keys())
        return loss, loss_for_grad, aux


    # ------------------------------------------------------------------
    def get_serializable(self):
        return self.params.get_serializable()

    def save(self, zip_filename):
        """Save to a single zip: graph skeletons, parameters, constants
        and the configuration (observed variables, fixed UUIDs)."""
        params, array_constants, prim_constants = self.get_serializable()
        graphs_json = [g.as_json() for g in self.graphs]
        config = {
            "observed_names": self.observed_variable_names,
            "observed_uuids": self.observed_variable_UUIDs,
            # which parameter UUIDs are fixed (module caches, frozen
            # carryover), restored through the uuid_map at load so that a
            # resumed training run does not train cache state
            "fixed_uuids": sorted(self.params.fixed),
        }
        with zipfile.ZipFile(zip_filename, "w") as zf:
            zf.writestr(FILENAMES["version"], json.dumps(
                {"serialization_version": SERIALIZATION_VERSION,
                 "library_version": __version__}))
            zf.writestr(FILENAMES["graphs"], json.dumps(graphs_json))
            zf.writestr(FILENAMES["params"], make_numpy_zip_bytes(params))
            zf.writestr(FILENAMES["array_constants"],
                        make_numpy_zip_bytes(array_constants))
            zf.writestr(FILENAMES["prim_constants"],
                        json.dumps(prim_constants))
            zf.writestr(FILENAMES["configuration"], json.dumps(config))

    def load(self, zip_filename):
        """Load a previous save into this (freshly rebuilt) inference.

        The caller has rebuilt the model graphs in code first; the
        loaded skeletons are matched onto them by name and topology, and
        the parameters remapped through the UUID map onto this store's
        device and dtype."""
        with zipfile.ZipFile(zip_filename, "r") as zf:
            version = json.loads(zf.read(FILENAMES["version"]))
            if version["serialization_version"] != SERIALIZATION_VERSION:
                raise SerializationError(
                    "Serialization version mismatch: {} vs {}.".format(
                        version["serialization_version"],
                        SERIALIZATION_VERSION))
            graphs_json = json.loads(zf.read(FILENAMES["graphs"]))
            params = read_numpy_zip_bytes(zf.read(FILENAMES["params"]))
            array_constants = read_numpy_zip_bytes(
                zf.read(FILENAMES["array_constants"]))
            prim_constants = json.loads(
                zf.read(FILENAMES["prim_constants"]))
            config = json.loads(zf.read(FILENAMES["configuration"]))
        previous_graphs = FactorGraph.load_graphs_json(graphs_json)
        uuid_map = FactorGraph.reconcile_graphs(
            current_graphs=self.graphs,
            primary_previous_graph=previous_graphs[0],
            secondary_previous_graphs=previous_graphs[1:])
        InferenceParameters.load_parameters(
            uuid_map, params, array_constants, prim_constants,
            current_params=self.params)
        for prev_uuid in config.get("fixed_uuids", []):
            cur = uuid_map.get(prev_uuid, prev_uuid)
            if cur in self.params.param_dict:
                self.params.fixed.add(cur)
        self._initialized = True


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
