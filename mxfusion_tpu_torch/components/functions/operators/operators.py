"""Operator factors: lift single tensor ops into the model graph.

Counterpart of ``mxfusion_tpu/components/functions/operators/operators.py``
(so far the :class:`Operator` base class; the ``operator_definition``
decorator comes with the operator library).
"""
from ..function_evaluation import FunctionEvaluation


class Operator(FunctionEvaluation):
    """Factor applying one tensor operator to its inputs; ``properties``
    hold the static arguments (axes, shapes)."""

    def __init__(self, inputs, outputs, operator_name, properties=None,
                 broadcastable=False):
        input_names = [v[0] for v in inputs]
        output_names = [v[0] for v in outputs]
        self._properties = properties if properties is not None else {}
        self.operator_name = operator_name
        super().__init__(inputs=inputs, outputs=outputs,
                         input_names=input_names, output_names=output_names,
                         broadcastable=broadcastable)

    @property
    def properties(self):
        return self._properties

    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        replica._properties = dict(self._properties)
        replica.operator_name = self.operator_name
        return replica
