"""Operator library.

Counterpart of ``mxfusion_tpu/components/functions/operators/
operator_impl.py``. So far the elementwise block (arithmetic,
``exp``, ``log`` and the links ``sigmoid``, ``softplus`` and ``probit``
that the non-Gaussian SVGP modules' generative graphs use), ``dot``
(the PPCA model's ``z·W``) and ``broadcast_to``, which the SVGP modules
use to broadcast a noise variance or a dispersion over the data.
Elementwise operators broadcast the sample axis along.
"""
import torch

from .operators import operator_definition, Operator
from ...variables.variable import Variable
from ...variables.runtime_variable import align_sample_arrays
from ....ops import elementwise
from ....util.inference import realize_shape


def _aligned(x, y):
    """Sample-aware elementwise alignment (see align_sample_arrays)."""
    x, y = align_sample_arrays([x, y])
    return x, y


# --- basic arithmetic (elementwise, sample axis broadcasts) -------------

@operator_definition(name="add", args=["x", "y"], inputs=["x", "y"])
def add(x, y):
    x, y = _aligned(x, y)
    return x + y


@operator_definition(name="subtract", args=["x", "y"], inputs=["x", "y"])
def subtract(x, y):
    x, y = _aligned(x, y)
    return x - y


@operator_definition(name="multiply", args=["x", "y"], inputs=["x", "y"])
def multiply(x, y):
    x, y = _aligned(x, y)
    return x * y


@operator_definition(name="divide", args=["x", "y"], inputs=["x", "y"])
def divide(x, y):
    x, y = _aligned(x, y)
    return x / y


@operator_definition(name="power", args=["x", "y"], inputs=["x", "y"])
def power(x, y):
    x, y = _aligned(x, y)
    return x ** y


# --- elementwise ---------------------------------------------------------

@operator_definition(name="square", args=["data"], inputs=["data"])
def square(data):
    return torch.square(data)


@operator_definition(name="exp", args=["data"], inputs=["data"])
def exp(data):
    return torch.exp(data)


@operator_definition(name="sigmoid", args=["data"], inputs=["data"])
def sigmoid(data):
    return torch.sigmoid(data)


@operator_definition(name="tanh", args=["data"], inputs=["data"])
def tanh(data):
    return torch.tanh(data)


@operator_definition(name="softplus", args=["data"], inputs=["data"])
def softplus(data):
    return elementwise.softplus(data)


@operator_definition(name="probit", args=["data"], inputs=["data"])
def probit(data):
    """Standard-normal CDF (the probit link)."""
    return torch.special.ndtr(data)


@operator_definition(name="log", args=["data"], inputs=["data"])
def log(data):
    return torch.log(data)


# --- matrix ops (batched over the sample axis) ----------------------------

@operator_definition(name="dot", args=["x", "y"], inputs=["x", "y"])
def dot(x, y):
    return torch.matmul(x, y)


# --- special: broadcast_to with symbolic target shape --------------------

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
