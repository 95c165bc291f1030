"""Static kernels: Bias and White.

Counterpart of ``mxfusion_tpu/components/distributions/gp/kernels/
static.py``.
"""
import torch

from .kernel import NativeKernel


class Bias(NativeKernel):
    """Constant covariance ``K_ij = variance``."""

    def __init__(self, input_dim, variance=1., name="bias", active_dims=None,
                 dtype=None):
        super().__init__(input_dim=input_dim, name=name,
                         active_dims=active_dims, dtype=dtype)
        self.variance = self._make_param(variance, (1,))

    def _compute_K(self, X, X2=None, variance=None):
        N = X.shape[-2]
        M = N if X2 is None else X2.shape[-2]
        return torch.unsqueeze(variance, -1) * torch.ones(
            tuple(X.shape[:-2]) + (N, M), dtype=X.dtype, device=X.device)

    def _compute_Kdiag(self, X, variance=None):
        return torch.broadcast_to(variance, X.shape[:-1])


class White(NativeKernel):
    """Diagonal noise: ``variance·I`` on X-vs-X, zero across sets."""

    def __init__(self, input_dim, variance=1., name="white", active_dims=None,
                 dtype=None):
        super().__init__(input_dim=input_dim, name=name,
                         active_dims=active_dims, dtype=dtype)
        self.variance = self._make_param(variance, (1,))

    def _compute_K(self, X, X2=None, variance=None):
        N = X.shape[-2]
        if X2 is None:
            eye = torch.eye(N, dtype=X.dtype, device=X.device)
            return torch.unsqueeze(variance, -1) * eye
        M = X2.shape[-2]
        return torch.zeros(tuple(X.shape[:-2]) + (N, M), dtype=X.dtype,
                           device=X.device)

    def _compute_Kdiag(self, X, variance=None):
        return torch.broadcast_to(variance, X.shape[:-1])
