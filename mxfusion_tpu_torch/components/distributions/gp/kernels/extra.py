"""Kernels beyond the reference's set: RationalQuadratic, Periodic,
Polynomial.

Counterpart of ``mxfusion_tpu/components/distributions/gp/kernels/
extra.py``. They compose with the same Add/Multiply/active_dims
machinery, and run as plain torch on both devices.
"""
import math

import torch

from .stationary import StationaryKernel
from .....ops.precision import einsum as p_einsum


class RationalQuadratic(StationaryKernel):
    """K = variance * (1 + R2 / (2 alpha))^(-alpha) — a scale mixture of
    RBF kernels over lengthscales; ``alpha -> inf`` recovers RBF."""

    def __init__(self, input_dim, ARD=False, variance=1., lengthscale=1.,
                 alpha=2., name="ratquad", active_dims=None, dtype=None):
        super().__init__(input_dim=input_dim, ARD=ARD, variance=variance,
                         lengthscale=lengthscale, name=name,
                         active_dims=active_dims, dtype=dtype)
        self.alpha = self._make_param(alpha, (1,))

    def _compute_K(self, X, X2=None, lengthscale=None, variance=None,
                   alpha=None):
        R2 = self._compute_R2(X, X2, lengthscale)
        a = torch.unsqueeze(alpha, -1)
        v = torch.unsqueeze(variance, -1)
        return v * torch.pow(1.0 + R2 / (2.0 * a), -a)

    def _compute_Kdiag(self, X, lengthscale=None, variance=None,
                       alpha=None):
        return torch.broadcast_to(variance, X.shape[:-1])


class Periodic(StationaryKernel):
    """Exact periodic (MacKay) kernel, summed over the input dims:

        K = variance * exp(-2 sum_d sin^2(pi (x_d - x'_d) / period) / l^2)
    """

    def __init__(self, input_dim, ARD=False, variance=1., lengthscale=1.,
                 period=1., name="periodic", active_dims=None, dtype=None):
        super().__init__(input_dim=input_dim, ARD=ARD, variance=variance,
                         lengthscale=lengthscale, name=name,
                         active_dims=active_dims, dtype=dtype)
        self.period = self._make_param(
            period, (input_dim,) if ARD else (1,))

    def _compute_K(self, X, X2=None, lengthscale=None, variance=None,
                   period=None):
        X2v = X if X2 is None else X2
        # pairwise per-dimension differences (..., N, M, D)
        diff = torch.unsqueeze(X, -2) - torch.unsqueeze(X2v, -3)
        p = period[..., None, None, :]
        ls = lengthscale[..., None, None, :]
        s = torch.sin(math.pi * diff / p) / ls
        v = torch.unsqueeze(variance, -1)
        return v * torch.exp(-2.0 * torch.sum(torch.square(s), dim=-1))

    def _compute_Kdiag(self, X, lengthscale=None, variance=None,
                       period=None):
        return torch.broadcast_to(variance, X.shape[:-1])


class Polynomial(StationaryKernel):
    """K = variance * (offset + x·x' / lengthscale²)^degree — the
    inhomogeneous polynomial kernel; ``degree`` is a static
    (non-trainable) integer."""

    def __init__(self, input_dim, degree=2, ARD=False, variance=1.,
                 lengthscale=1., offset=1., name="poly",
                 active_dims=None, dtype=None):
        super().__init__(input_dim=input_dim, ARD=ARD, variance=variance,
                         lengthscale=lengthscale, name=name,
                         active_dims=active_dims, dtype=dtype)
        self.degree = int(degree)
        self.offset = self._make_param(offset, (1,))

    def _dot(self, X, X2, lengthscale):
        # HIGHEST: the power amplifies the product's rounding
        ls = torch.unsqueeze(lengthscale, -2)
        Xs = X / ls
        X2s = Xs if X2 is None else X2 / ls
        return p_einsum("...nd,...md->...nm", Xs, X2s)

    def _compute_K(self, X, X2=None, lengthscale=None, variance=None,
                   offset=None):
        d = self._dot(X, X2, lengthscale)
        v = torch.unsqueeze(variance, -1)
        o = torch.unsqueeze(offset, -1)
        return v * torch.pow(o + d, self.degree)

    def _compute_Kdiag(self, X, lengthscale=None, variance=None,
                       offset=None):
        ls = torch.unsqueeze(lengthscale, -2)
        Xs = X / ls
        d = torch.sum(Xs * Xs, dim=-1)
        return variance * torch.pow(offset + d, self.degree)
