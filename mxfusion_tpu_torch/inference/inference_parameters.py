"""InferenceParameters: the UUID-keyed parameter store.

Counterpart of ``mxfusion_tpu/inference/inference_parameters.py``:
``{uuid: tensor}`` of *unconstrained* parameter values (bijectors are
applied when the env is built), a constants dict (python ints for
symbolic shape dims plus numpy arrays), and a ``fixed`` set marking
non-trainable entries (module caches, carried-over parameters). The
store has one dtype and one device; every tensor in it lives there.
Save/load comes later.
"""
import torch

from ..common.config import as_torch_dtype, resolve_device
from ..components.variables.variable import Variable
from ..util.inference import realize_shape


class InferenceParameters:
    def __init__(self, constants=None, dtype=None, device=None):
        self._params = {}
        self._constants = dict(constants) if constants else {}
        self._fixed = set()
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    @property
    def param_dict(self):
        """{uuid: unconstrained tensor}."""
        return self._params

    @property
    def constants(self):
        return self._constants

    @property
    def fixed(self):
        return self._fixed

    def trainable_params(self):
        return {k: v for k, v in self._params.items()
                if k not in self._fixed}

    def fixed_params(self):
        return {k: v for k, v in self._params.items() if k in self._fixed}

    def as_tensor(self, value):
        """``value`` as a tensor of this store's dtype on its device."""
        return torch.as_tensor(value, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    def initialize_params(self, graphs, observed_uuids, generator=None):
        """Walk graphs, realize shapes, and allocate parameter tensors.

        Constants get their values; parameters get their
        (inverse-transformed) initial value or a uniform(-0.07, 0.07)
        draw from ``generator`` (default: seeded with 0 on the store's
        device).
        """
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        excluded = set(observed_uuids)
        for g in graphs:
            excluded.update(g.var_ties.keys())
        for g in graphs:
            for v in g.get_constants():
                if v.uuid not in self._constants:
                    self._constants[v.uuid] = v.constant
            for m in g.modules.values():
                m.initialize_hidden_parameters(self, excluded, generator)
            for v in g.get_parameters(excluded=excluded):
                # symbolic shape dims bound from data live in constants
                if v.uuid in self._params or v.uuid in self._constants:
                    continue
                self._params[v.uuid] = self._init_value(v, generator)

    def allocate(self, v, generator, zero_init=False):
        """Allocate storage for one Variable if not already present."""
        if v.uuid in self._params:
            return
        if zero_init:
            shape = realize_shape(v.shape, self._constants)
            self._params[v.uuid] = torch.zeros(shape, dtype=self.dtype,
                                               device=self.device)
        else:
            self._params[v.uuid] = self._init_value(v, generator)

    def _init_value(self, v, generator):
        shape = realize_shape(v.shape, self._constants)
        init = v.initial_value_before_transformation
        if init is not None:
            return torch.broadcast_to(self.as_tensor(init), shape).clone()
        u = torch.rand(shape, generator=generator, dtype=self.dtype,
                       device=self.device)
        return -0.07 + u * 0.14

    # ------------------------------------------------------------------
    def initialize_with_carryover_params(self, graphs, observed_uuids,
                                         carryover_params, generator=None,
                                         fix_carryover=True):
        """Initialize, then overwrite with values carried from a previous
        inference run. ``carryover_params`` is a {uuid: unconstrained
        value} dict; matching is by UUID (model and posterior share
        variable identity via replication)."""
        self.initialize_params(graphs, observed_uuids, generator=generator)
        all_uuids = set()
        for g in graphs:
            all_uuids.update(g.components.keys())
            for m in g.modules.values():
                for ig in m.internal_graphs:
                    all_uuids.update(ig.components.keys())
        for uuid, value in carryover_params.items():
            if uuid in all_uuids:
                self._params[uuid] = self.as_tensor(value)
                if fix_carryover:
                    self._fixed.add(uuid)

    # ------------------------------------------------------------------
    # transformed access by Variable
    # ------------------------------------------------------------------
    def __getitem__(self, variable):
        if not isinstance(variable, Variable):
            raise KeyError("Index InferenceParameters with a Variable.")
        if variable.uuid in self._params:
            raw = self._params[variable.uuid]
            if variable.transformation is not None:
                return variable.transformation.transform(raw)
            return raw
        if variable.uuid in self._constants:
            return self._constants[variable.uuid]
        raise KeyError(variable)

    def __setitem__(self, variable, value):
        if not isinstance(variable, Variable):
            raise KeyError("Index InferenceParameters with a Variable.")
        if variable.transformation is not None:
            value = variable.transformation.inverse_transform(value)
        self._params[variable.uuid] = self.as_tensor(value)

    def __contains__(self, variable):
        uuid = variable.uuid if isinstance(variable, Variable) else variable
        return uuid in self._params or uuid in self._constants
