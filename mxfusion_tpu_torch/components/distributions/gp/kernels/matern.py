"""Matern kernels (orders 1/2, 3/2, 5/2).

Counterpart of ``mxfusion_tpu/components/distributions/gp/kernels/
matern.py``. Plain torch on both devices: only ``RBF`` has a kernel of
its own.
"""
import math

import torch

from .stationary import StationaryKernel

SQRT3 = math.sqrt(3.0)
SQRT5 = math.sqrt(5.0)


class Matern(StationaryKernel):
    """Matern kernel with half-integer order ``order`` in {0, 1, 2} for
    ν = order + 1/2."""

    def __init__(self, input_dim, order, ARD=False, variance=1.,
                 lengthscale=1., name="matern", active_dims=None, dtype=None):
        super().__init__(input_dim=input_dim, ARD=ARD, variance=variance,
                         lengthscale=lengthscale, name=name,
                         active_dims=active_dims, dtype=dtype)
        self.order = order

    def _compute_K(self, X, X2=None, lengthscale=None, variance=None):
        R2 = self._compute_R2(X, X2, lengthscale)
        # sqrt has an infinite gradient at 0 (coincident points): clamp
        R = torch.sqrt(torch.clamp(R2, min=1e-36))
        v = torch.unsqueeze(variance, -1)
        if self.order == 0:      # ν = 1/2 (exponential / OU)
            return v * torch.exp(-R)
        if self.order == 1:      # ν = 3/2
            return v * (1.0 + SQRT3 * R) * torch.exp(-SQRT3 * R)
        if self.order == 2:      # ν = 5/2
            return v * (1.0 + SQRT5 * R + (5.0 / 3.0) * R2) * \
                torch.exp(-SQRT5 * R)
        raise NotImplementedError(
            "Matern order {} not supported.".format(self.order))


class Matern12(Matern):
    def __init__(self, input_dim, ARD=False, variance=1., lengthscale=1.,
                 name="matern12", active_dims=None, dtype=None):
        super().__init__(input_dim=input_dim, order=0, ARD=ARD,
                         variance=variance, lengthscale=lengthscale,
                         name=name, active_dims=active_dims, dtype=dtype)


class Matern32(Matern):
    def __init__(self, input_dim, ARD=False, variance=1., lengthscale=1.,
                 name="matern32", active_dims=None, dtype=None):
        super().__init__(input_dim=input_dim, order=1, ARD=ARD,
                         variance=variance, lengthscale=lengthscale,
                         name=name, active_dims=active_dims, dtype=dtype)


class Matern52(Matern):
    def __init__(self, input_dim, ARD=False, variance=1., lengthscale=1.,
                 name="matern52", active_dims=None, dtype=None):
        super().__init__(input_dim=input_dim, order=2, ARD=ARD,
                         variance=variance, lengthscale=lengthscale,
                         name=name, active_dims=active_dims, dtype=dtype)
