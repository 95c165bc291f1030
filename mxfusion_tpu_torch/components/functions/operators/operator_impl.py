"""Operator library.

Counterpart of ``mxfusion_tpu/components/functions/operators/
operator_impl.py``: the elementwise block (arithmetic, ``exp``,
``log`` and the links ``sigmoid``, ``softplus`` and ``probit``), the
reductions ``sum``, ``mean`` and ``prod``, the matrix operators ``dot``
and ``diag``, ``reshape``, ``transpose`` and ``broadcast_to``.
Elementwise operators broadcast the sample axis along; the axes of the
others count from the first axis after the sample axis.
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


def _shift_axis(axis):
    """Shift a user-facing axis by +1 for the leading sample axis."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        return tuple(a + 1 if a >= 0 else a for a in axis)
    return axis + 1 if axis >= 0 else axis


def _reduce(reduce, data, axis):
    """``reduce(data, dim)`` over the shifted ``axis``, one axis at a
    time from the last; ``None`` reduces every axis but the sample
    axis. An empty set of axes leaves ``data`` as it is (``torch.sum``
    would read ``dim=()`` as every axis)."""
    ax = _shift_axis(axis) if axis is not None else tuple(
        range(1, data.ndim))
    if not isinstance(ax, tuple):
        ax = (ax,)
    for a in sorted((a % data.ndim for a in ax), reverse=True):
        data = reduce(data, a)
    return data


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


# --- aggregation (axes exclude the sample axis) --------------------------

@operator_definition(name="sum", args=["data", "axis"], inputs=["data"])
def sum(data, axis=None):
    return _reduce(torch.sum, data, axis)


@operator_definition(name="mean", args=["data", "axis"], inputs=["data"])
def mean(data, axis=None):
    return _reduce(torch.mean, data, axis)


@operator_definition(name="prod", args=["data", "axis"], inputs=["data"])
def prod(data, axis=None):
    return _reduce(torch.prod, data, axis)


# --- matrix ops (batched over the sample axis) ----------------------------

@operator_definition(name="dot", args=["x", "y"], inputs=["x", "y"])
def dot(x, y):
    return torch.matmul(x, y)


@operator_definition(name="diag", args=["data", "k"], inputs=["data"])
def diag(data, k=0):
    """``numpy.diag`` with offset ``k`` under the sample axis: a vector
    (``data.ndim < 3``) becomes a matrix with the vector on its k-th
    diagonal, a matrix gives its k-th diagonal."""
    if data.ndim >= 3:
        return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)
    return torch.diag_embed(data, offset=k)


# --- manipulations --------------------------------------------------------

@operator_definition(name="reshape", args=["data", "shape", "reverse"],
                     inputs=["data"])
def reshape(data, shape, reverse=False):
    return torch.reshape(data, (data.shape[0],) + tuple(shape))


@operator_definition(name="transpose", args=["data", "axes"],
                     inputs=["data"])
def transpose(data, axes=None):
    if axes is None:
        axes = tuple(range(data.ndim - 1, 0, -1))
    else:
        axes = tuple(_shift_axis(a) for a in axes)
    return torch.permute(data, (0,) + tuple(axes))


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
