"""Factor base class: distributions, deterministic functions, modules.

Counterpart of ``mxfusion_tpu/components/factor.py``: named-edge
inputs/outputs (``[('mean', v), ('variance', w)]``), auto-wrapping of
python scalars / numpy arrays into CONSTANT Variables, attribute access
to inputs/outputs by name, and UUID-preserving replication. Runtime
values are fetched from a UUID-keyed env of tensors.
"""
import numpy as np

from .model_component import ModelComponent
from .variables.variable import Variable
from ..common.exceptions import ModelSpecificationError


class Factor(ModelComponent):
    """A graph node with named input and output Variables.

    ``input_names`` / ``output_names`` fix the edge-label order; the
    ``inputs``/``outputs`` properties reconstruct ordered lists from the
    (unordered) graph adjacency using those names.
    """

    #: whether the factor's log-pdf over a variable whose leading axis is the
    #: data rows is a sum of one term per row, so the data-parallel loops
    #: may split the rows over a mesh (``parallel.data_parallel``);
    #: unknown is False, which makes them compute on the whole data
    row_separable = False

    def __init__(self, inputs, outputs, input_names, output_names):
        super().__init__()
        self.input_names = list(input_names) if input_names is not None else []
        self.output_names = list(output_names) if output_names is not None else []
        if inputs:
            wrapped = [(name, self._as_variable(var)) for name, var in inputs]
            for name, var in wrapped:
                self.add_predecessor(name, var)
        if outputs:
            for name, var in outputs:
                self.add_successor(name, var)

    @staticmethod
    def _as_variable(value):
        """Wrap python scalars / numpy arrays / tensors into constant
        Variables."""
        if isinstance(value, Variable):
            return value
        if isinstance(value, (int, float, np.ndarray)):
            return Variable(value=value)
        if hasattr(value, "shape") and hasattr(value, "dtype"):
            return Variable(value=np.asarray(value))
        raise ModelSpecificationError(
            "Cannot use {} as a factor input.".format(type(value)))

    # ------------------------------------------------------------------
    @property
    def inputs(self):
        """Ordered ``[(name, Variable)]`` in declared input order."""
        by_name = {}
        for label, pred in self.predecessors:
            by_name[label] = pred
        return [(n, by_name[n]) for n in self.input_names if n in by_name]

    @property
    def outputs(self):
        by_name = {}
        for label, succ in self.successors:
            by_name[label] = succ
        return [(n, by_name[n]) for n in self.output_names if n in by_name]

    def __getattr__(self, name):
        # called only when normal lookup fails; expose inputs/outputs by name
        if name.startswith("_") or name in ("input_names", "output_names"):
            raise AttributeError(name)
        input_names = self.__dict__.get("input_names", ())
        output_names = self.__dict__.get("output_names", ())
        if name in input_names:
            for label, pred in self.predecessors:
                if label == name:
                    return pred
            raise AttributeError(name)
        if name in output_names:
            for label, succ in self.successors:
                if label == name:
                    return succ
            raise AttributeError(name)
        raise AttributeError(name)

    # ------------------------------------------------------------------
    def set_outputs(self, variables):
        """(Re)wire the output variables of this factor ."""
        variables = variables if isinstance(variables, (list, tuple)) else [variables]
        if len(variables) != len(self.output_names):
            raise ModelSpecificationError(
                "Factor {} expects {} outputs, got {}.".format(
                    self, len(self.output_names), len(variables)))
        self.successors = []
        for name, var in zip(self.output_names, variables):
            self.add_successor(name, var)

    def set_single_input(self, name, variable):
        """Replace the input edge ``name`` with ``variable``."""
        variable = self._as_variable(variable)
        preds = [(l, p) for l, p in self.predecessors if l != name]
        preds.append((name, variable))
        if self.graph is None:
            # detach old link in bi-directional mode
            for l, p in self.predecessors:
                if l == name:
                    p._successors = [(sl, s) for sl, s in p._successors
                                     if not (sl == name and s is self)]
            self._predecessors = preds
            variable._successors.append((name, self))
        else:
            self.predecessors = preds

    # ------------------------------------------------------------------
    # runtime helpers (UUID-keyed env of tensors)
    # ------------------------------------------------------------------
    def fetch_runtime_inputs(self, env):
        """``{input_name: env[var.uuid]}``."""
        return {name: env[var.uuid] for name, var in self.inputs}

    def fetch_runtime_outputs(self, env):
        return {name: env[var.uuid] for name, var in self.outputs}

    # ------------------------------------------------------------------
    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        replica.input_names = list(self.input_names)
        replica.output_names = list(self.output_names)
        return replica

    def as_json(self):
        j = super().as_json()
        j["input_names"] = self.input_names
        j["output_names"] = self.output_names
        return j
