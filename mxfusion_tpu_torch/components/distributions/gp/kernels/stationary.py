"""Stationary kernels: ARD lengthscale + variance, scaled squared distance.

Counterpart of ``mxfusion_tpu/components/distributions/gp/kernels/
stationary.py``. The scaled squared distance uses the
``|x|² + |x'|² − 2 x·x'`` expansion whose cross term is one batched
matmul.
"""
import torch

from .kernel import NativeKernel
from .....ops.precision import einsum as p_einsum


class StationaryKernel(NativeKernel):
    """Base for kernels that depend only on scaled distance r = |x - x'| / l."""

    def __init__(self, input_dim, ARD=False, variance=1., lengthscale=1.,
                 name="stationary", active_dims=None, dtype=None):
        super().__init__(input_dim=input_dim, name=name,
                         active_dims=active_dims, dtype=dtype)
        self.ARD = ARD
        ls_shape = (input_dim,) if ARD else (1,)
        self.lengthscale = self._make_param(lengthscale, ls_shape)
        self.variance = self._make_param(variance, (1,))

    def _compute_R2(self, X, X2, lengthscale):
        """Scaled squared distance matrix (..., N, M), clamped at 0."""
        ls = torch.unsqueeze(lengthscale, -2)  # (..., 1, D)
        Xs = X / ls
        X2s = Xs if X2 is None else X2 / ls
        # the expansion relies on CANCELLATION between large terms, so
        # the cross product stays at the HIGHEST tier (IEEE fp32 on the
        # card, never TF32)
        cross = p_einsum("...nd,...md->...nm", Xs, X2s)
        x1sq = torch.sum(torch.square(Xs), dim=-1)
        x2sq = torch.sum(torch.square(X2s), dim=-1)
        R2 = x1sq[..., :, None] + x2sq[..., None, :] - 2.0 * cross
        return torch.clamp(R2, min=0.0)

    def _compute_Kdiag(self, X, lengthscale, variance):
        return torch.broadcast_to(variance, X.shape[:-1])
