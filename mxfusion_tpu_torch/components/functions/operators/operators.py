"""Operator factors: lift single tensor ops into the model graph.

Counterpart of ``mxfusion_tpu/components/functions/operators/operators.py``
A decorator generates one Operator subclass per op, splitting call
arguments into differentiable ``inputs`` (Variables) and static
``properties`` (axes, shapes).
"""
from ....common.exceptions import ModelSpecificationError
from ..function_evaluation import FunctionEvaluation
from ...variables.variable import Variable


# operators that may mix the data rows (``Operator.row_separable``)
_ROW_MIXING = ("sum", "mean", "prod", "reshape", "transpose", "diag")


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

    @property
    def row_separable(self):
        """Reductions and reshapes may mix the data rows; the other
        operators act row by row."""
        return self.operator_name not in _ROW_MIXING

    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        replica._properties = dict(self._properties)
        replica.operator_name = self.operator_name
        return replica


class operator_definition:
    """Decorator turning a tensor function into a graph-operator
    constructor.

    ``args`` lists all argument names in order; ``inputs`` is the subset
    that are graph Variables (differentiable); the rest become static
    properties.
    """

    def __init__(self, name, args, inputs, num_outputs=1,
                 broadcastable=True):
        self.operator_name = name
        self.arg_names = args
        self.input_names = inputs
        self.property_names = [v for v in args if v not in inputs]
        self.num_outputs = num_outputs
        self.broadcastable = broadcastable

    def _parse_arguments(self, args, kwargs):
        arg_names = [v for v in self.arg_names if v not in kwargs]
        arguments = dict(kwargs)
        arguments.update({k: v for k, v in zip(arg_names, args)})
        return arguments

    def __call__(self, func):
        outer = self

        def create_operator(*args, **kwargs):
            all_args = outer._parse_arguments(args, kwargs)

            class CustomOperator(Operator):
                def eval_impl(self, **input_kws):
                    input_kws.update(self.properties)
                    return func(**input_kws)

            CustomOperator.__name__ = outer.operator_name + "Operator"
            missing = [n for n in outer.input_names if n not in all_args]
            if missing:
                raise ModelSpecificationError(
                    "Operator {} missing inputs {}.".format(
                        outer.operator_name, missing))
            op = CustomOperator(
                inputs=[(n, all_args[n]) for n in outer.input_names],
                outputs=[("output_" + str(i), Variable())
                         for i in range(outer.num_outputs)],
                operator_name=outer.operator_name,
                properties={n: all_args[n] for n in outer.property_names
                            if n in all_args},
                broadcastable=outer.broadcastable)
            outs = [op.outputs[i][1] for i in range(outer.num_outputs)]
            return outs[0] if outer.num_outputs == 1 else tuple(outs)

        create_operator.__name__ = self.operator_name
        return create_operator
