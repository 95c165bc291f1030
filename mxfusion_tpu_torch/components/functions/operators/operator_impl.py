"""Operator library.

Counterpart of ``mxfusion_tpu/components/functions/operators/
operator_impl.py``. So far only ``broadcast_to``, which the SVGP module
uses to broadcast its noise variance over the data.
"""
import torch

from .operators import Operator
from ...variables.variable import Variable
from ....util.inference import realize_shape


class BroadcastToOperator(Operator):
    def __init__(self, data, shape):
        super().__init__(
            inputs=[("data", data)],
            outputs=[("output_0", Variable())],
            operator_name="broadcast_to",
            properties={"shape": shape},
            broadcastable=True)

    def eval(self, env):
        target_shape = realize_shape(self.properties["shape"], env)
        arr = env[self.inputs[0][1].uuid]
        if arr.ndim == 0:  # scalar constant: give it a sample axis
            arr = arr[None]
        source_shape = arr.shape
        n_target = len(target_shape)
        n_source = len(source_shape)
        if n_target + 1 - n_source > 0:
            t_shape = (source_shape[0],) + \
                (1,) * (n_target + 1 - n_source) + tuple(source_shape[1:])
            arr = torch.reshape(arr, t_shape)
        out = torch.broadcast_to(arr, (source_shape[0],) + target_shape)
        return {self.output_names[0]: out}


def broadcast_to(data, shape):
    """Broadcast a variable to a (possibly symbolic) target shape; the
    symbolic dims are realized against the env's shape constants."""
    op = BroadcastToOperator(data=data, shape=shape)
    return op.outputs[0][1]
