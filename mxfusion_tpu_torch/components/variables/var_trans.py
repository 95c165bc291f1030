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


def _softplus(x):
    # logaddexp(x, 0), as jnp.logaddexp computes it
    return torch.logaddexp(x, torch.zeros_like(x))


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
