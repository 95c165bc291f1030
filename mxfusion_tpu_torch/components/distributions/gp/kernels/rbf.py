"""RBF (squared-exponential) kernel.

Counterpart of ``mxfusion_tpu/components/distributions/gp/kernels/
rbf.py``. ``K = variance * exp(-R²/2)``. Where
``mxfusion_tpu_torch.ops.cuda_kernels.kernel_eligible`` holds (float32
inputs of the shapes the kernel takes), K comes from
``rbf_kernel_matrix``: on the card, the hand-written CUDA gram kernel in
one pass (scaling, cross term, clamp and exp fused). Other inputs take
the plain branch, as JAX's gate sends them to ``_rbf_jnp``. Inside an
``AddKernel`` or ``MultiplyKernel`` an RBF builds each of its grams the
same way, one launch per gram; with ``active_dims`` it takes the dense
copy that ``Kernel.K``'s ``index_select`` makes of the chosen columns.
``Kdiag`` stays plain.
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
        if kernel_eligible(X, X2, lengthscale, variance):
            # the sample axis arrives broadcast as a stride-0 view
            # (as_samples); the kernel reads dense rows, so copy it: s·N·D
            # floats, small beside the s·N·M gram
            return rbf_kernel_matrix(
                X.contiguous(), None if X2 is None else X2.contiguous(),
                lengthscale, variance)
        R2 = self._compute_R2(X, X2, lengthscale)
        return torch.unsqueeze(variance, -1) * torch.exp(-0.5 * R2)
