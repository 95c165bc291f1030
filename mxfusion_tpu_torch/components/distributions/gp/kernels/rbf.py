"""RBF (squared-exponential) kernel.

Counterpart of ``mxfusion_tpu/components/distributions/gp/kernels/
rbf.py``. ``K = variance * exp(-R²/2)``. Where
``mxfusion_tpu_torch.ops.cuda_kernels.kernel_eligible`` holds, K comes
from ``rbf_kernel_matrix``: on the card, the hand-written CUDA gram
kernel in one pass (scaling, cross term, clamp and exp fused).
"""
import torch

from .stationary import StationaryKernel


class RBF(StationaryKernel):
    def __init__(self, input_dim, ARD=False, variance=1., lengthscale=1.,
                 name="rbf", active_dims=None, dtype=None):
        super().__init__(input_dim=input_dim, ARD=ARD, variance=variance,
                         lengthscale=lengthscale, name=name,
                         active_dims=active_dims, dtype=dtype)

    def _compute_K(self, X, X2=None, lengthscale=None, variance=None):
        from .....ops.cuda_kernels import rbf_kernel_matrix, kernel_eligible
        if kernel_eligible(X, X2):
            return rbf_kernel_matrix(X, X2, lengthscale, variance)
        R2 = self._compute_R2(X, X2, lengthscale)
        return torch.unsqueeze(variance, -1) * torch.exp(-0.5 * R2)
