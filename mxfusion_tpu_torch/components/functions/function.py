"""User-defined function objects.

Counterpart of ``mxfusion_tpu/components/functions/function.py``.
Calling a :class:`Function` during model definition creates a
:class:`FunctionEvaluationWithParameters` factor and returns the output
Variable(s). The wrapped callable is any function of tensors.
"""
from .function_evaluation import FunctionEvaluationWithParameters
from ..variables.variable import Variable
from ...common.exceptions import ModelSpecificationError


class Function:
    """Wrap a callable on tensors as a reusable model function.

    Parameters
    ----------
    func : callable
        Function of the named inputs (tensors), returning one tensor
        or a tuple of tensors.
    input_names, output_names : list of str
    parameters : dict of {name: Variable}, optional
        Trainable/latent parameter Variables closed over by the function;
        ``func`` receives them via the ``params`` keyword dict.
    broadcastable : bool
        Whether the function tolerates a leading sample axis on every
        input (evaluated once); otherwise it is vmapped per sample.
    """

    def __init__(self, func, input_names, output_names, parameters=None,
                 broadcastable=False, name=None):
        self._callable = func
        self.name = name if name is not None else getattr(
            func, "__name__", "function")
        self.input_names = list(input_names)
        self.output_names = list(output_names)
        self._parameters = dict(parameters) if parameters else {}
        self.broadcastable = broadcastable

    @property
    def parameters(self):
        return self._parameters

    @property
    def has_random_parameters(self):
        from ..variables.variable import VariableType
        return any(v.type == VariableType.RANDVAR
                   for v in self._parameters.values())

    def eval(self, params, **data):
        if self._parameters:
            return self._callable(params=params, **data)
        return self._callable(**data)

    def __call__(self, *args, **kwargs):
        """Apply during model definition: create the factor, return outputs."""
        named = dict(zip(self.input_names, args))
        named.update(kwargs)
        missing = [n for n in self.input_names if n not in named]
        if missing:
            raise ModelSpecificationError(
                "Missing inputs {} for function {}.".format(missing,
                                                            self.name))
        from ..factor import Factor
        input_variables = [(n, Factor._as_variable(named[n]))
                           for n in self.input_names]
        output_variables = [(n, Variable()) for n in self.output_names]
        FunctionEvaluationWithParameters(
            func=self, input_variables=input_variables,
            output_variables=output_variables,
            broadcastable=self.broadcastable)
        outs = [v for _, v in output_variables]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def replicate_self(self, attribute_map=None):
        replica = type(self).__new__(type(self))
        replica.__dict__.update(self.__dict__)
        if attribute_map is not None:
            replica._parameters = {
                n: attribute_map.get(v, v) for n, v in self._parameters.items()}
        return replica
