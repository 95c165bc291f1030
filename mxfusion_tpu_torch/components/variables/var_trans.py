"""Variable transformations (bijectors).

Counterpart of ``mxfusion_tpu/components/variables/var_trans.py``.
Unconstrained optimizer parameters are mapped into the model's
constrained space when the runtime env is built. The formulas are the
JAX package's exactly, so unconstrained values carry over between the
two packages as they are.
"""
from abc import ABC, abstractmethod

import numpy as np
import torch

from ...ops.elementwise import softplus as _softplus


def _softplus_inverse(y):
    # log(exp(y) - 1) computed stably: y + log(-expm1(-y))
    return y + torch.log(-torch.expm1(-y))


class VariableTransformation(ABC):
    """Bijector from unconstrained (optimizer) to constrained (model) space."""

    @abstractmethod
    def transform(self, var):
        """Unconstrained -> constrained."""

    @abstractmethod
    def inverse_transform(self, out_var):
        """Constrained -> unconstrained."""


class Softplus(VariableTransformation):
    """``y = softplus(x) + offset``."""

    def __init__(self, offset=0.0):
        self.offset = offset

    def transform(self, var):
        return _softplus(var) + self.offset

    def inverse_transform(self, out_var):
        # runs host-side at initialization: use numpy float64
        if isinstance(out_var, (int, float, np.ndarray)):
            y = np.asarray(out_var, dtype=np.float64) - self.offset
            return y + np.log1p(-np.exp(-y))
        return _softplus_inverse(out_var - self.offset)


class PositiveTransformation(Softplus):
    """Positivity constraint: softplus with zero offset."""

    def __init__(self):
        super().__init__(offset=0.0)


class SimplexTransformation(VariableTransformation):
    """Maps R^K onto the interior of the K-simplex via softmax over the
    last axis (MAP point-mass locations for simplex-support latents).
    Softmax is a smooth surjection, not a bijection; ``inverse_transform``
    is the right inverse ``log(x)``."""

    def transform(self, var):
        e = torch.exp(var - torch.amax(var, dim=-1, keepdim=True))
        return e / torch.sum(e, dim=-1, keepdim=True)

    def inverse_transform(self, out_var):
        if isinstance(out_var, (int, float, np.ndarray)):
            x = np.asarray(out_var, dtype=np.float64)
            return np.log(np.maximum(x, np.finfo(np.float64).tiny))
        return torch.log(torch.clamp(out_var,
                                     min=torch.finfo(out_var.dtype).tiny))


class Logistic(VariableTransformation):
    """Maps the real line to ``(lower, upper)`` via a scaled sigmoid."""

    def __init__(self, lower, upper):
        self.lower = lower
        self.upper = upper

    def transform(self, var):
        # sigmoid as 0.5·(tanh(x/2) + 1), the JAX package's formula
        return self.lower + (self.upper - self.lower) * 0.5 * (
            torch.tanh(0.5 * var) + 1.0)

    def inverse_transform(self, out_var):
        if isinstance(out_var, (int, float, np.ndarray)):
            p = (np.asarray(out_var, dtype=np.float64) - self.lower) / (
                self.upper - self.lower)
            return np.log(p) - np.log1p(-p)
        p = (out_var - self.lower) / (self.upper - self.lower)
        return torch.log(p) - torch.log1p(-p)
