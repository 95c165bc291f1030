"""Deterministic function-application factors.

Counterpart of ``mxfusion_tpu/components/functions/function_evaluation.py``.
Non-broadcastable functions are mapped over the sample axis with
``torch.func.vmap``, as the JAX package maps them with ``jax.vmap``.
"""
import torch

from ..factor import Factor
from ..variables.runtime_variable import arrays_as_samples


class FunctionEvaluation(Factor):
    """Factor recording one application of a deterministic function."""

    def __init__(self, inputs, outputs, input_names, output_names,
                 broadcastable=False):
        super().__init__(inputs=inputs, outputs=outputs,
                         input_names=input_names, output_names=output_names)
        self.broadcastable = broadcastable

    def eval(self, env):
        """Evaluate into ``{output_name: tensor-with-sample-axis}``.

        Broadcastable functions are evaluated once on tensors that still
        carry the sample axis; non-broadcastable functions are vmapped
        over a materialized common sample count.
        """
        inputs = self.fetch_runtime_inputs(env)
        names = list(inputs.keys())
        arrays = arrays_as_samples([inputs[n] for n in names])
        if self.broadcastable:
            results = self.eval_impl(**dict(zip(names, arrays)))
        else:
            def per_sample(*args):
                return self.eval_impl(**dict(zip(names, args)))
            results = torch.func.vmap(per_sample)(*arrays)
        if not isinstance(results, (list, tuple)):
            results = (results,)
        return dict(zip(self.output_names, results))

    def eval_impl(self, **input_kws):
        raise NotImplementedError

    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        replica.broadcastable = self.broadcastable
        return replica


class FunctionEvaluationWithParameters(FunctionEvaluation):
    """Function application whose wrapped function carries parameter
    Variables, merged into the factor's inputs so that priors over
    function parameters connect into the graph."""

    def __init__(self, func, input_variables, output_variables,
                 broadcastable=False):
        data_names = [n for n, _ in input_variables]
        param_pairs = [(n, v) for n, v in func.parameters.items()]
        inputs = list(input_variables) + param_pairs
        input_names = data_names + [n for n, _ in param_pairs]
        output_names = [n for n, _ in output_variables]
        self._func = func
        self._data_input_names = data_names
        super().__init__(
            inputs=inputs, outputs=output_variables,
            input_names=input_names, output_names=output_names,
            broadcastable=broadcastable and not func.has_random_parameters)

    @property
    def function(self):
        return self._func

    def eval_impl(self, **input_kws):
        data = {n: input_kws[n] for n in self._data_input_names}
        params = {n: v for n, v in input_kws.items()
                  if n not in self._data_input_names}
        return self._func.eval(params=params, **data)

    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        replica._func = self._func.replicate_self(attribute_map)
        replica._data_input_names = list(self._data_input_names)
        return replica
