"""Linear kernel.

Counterpart of ``mxfusion_tpu/components/distributions/gp/kernels/
linear.py``. ``K = X diag(v) X2ᵀ``: one batched product at the HIGHEST
tier (IEEE fp32 on the card), since K feeds a Cholesky.
"""
import torch

from .kernel import NativeKernel
from .....ops.precision import einsum as p_einsum


class Linear(NativeKernel):
    def __init__(self, input_dim, ARD=False, variances=1., name="linear",
                 active_dims=None, dtype=None):
        super().__init__(input_dim=input_dim, name=name,
                         active_dims=active_dims, dtype=dtype)
        self.ARD = ARD
        v_shape = (input_dim,) if ARD else (1,)
        self.variances = self._make_param(variances, v_shape)

    def _compute_K(self, X, X2=None, variances=None):
        v = torch.unsqueeze(variances, -2)  # (..., 1, D) or (..., 1, 1)
        Xv = X * v
        X2_ = X if X2 is None else X2
        return p_einsum("...nd,...md->...nm", Xv, X2_)

    def _compute_Kdiag(self, X, variances=None):
        v = torch.unsqueeze(variances, -2)
        return torch.sum(X * X * v, dim=-1)
