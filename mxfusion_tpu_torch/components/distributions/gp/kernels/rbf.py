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
Where X and X2 differ in sample count and one of them has s = 1 (the deep
GP's Kuf of a layer l ≥ 1: Z and the kernel's parameters at s = 1, the
propagated inputs at s = S), the s = 1 operands are expanded to S before
the gate and copied dense, so that the gram is one launch; autograd
through the expansion sums the gradients back over s. ``Kdiag`` stays
plain.
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
        operands = _one_sample_count(X, X2, lengthscale, variance)
        if kernel_eligible(*operands):
            # the sample axis arrives broadcast as a stride-0 view
            # (as_samples, or the expansion above); the kernel reads dense
            # rows, so copy it: s·N·D floats, small beside the s·N·M gram
            return rbf_kernel_matrix(*(None if t is None else t.contiguous()
                                       for t in operands))
        R2 = self._compute_R2(X, X2, lengthscale)
        return torch.unsqueeze(variance, -1) * torch.exp(-0.5 * R2)


def _one_sample_count(X, X2, lengthscale, variance):
    """The operands with the s = 1 ones expanded to the other sample
    count S, where X and X2 (both 3-D) differ in it and one of them has
    s = 1; otherwise as they are. The parameters expand along their
    leading (sample) axis only, so a (1, D) lengthscale with D = S stays
    one ARD lengthscale. An operand whose leading axis is neither 1 nor S
    leaves everything as it is, for the gate to refuse."""
    if X2 is None or X.ndim != 3 or X2.ndim != 3:
        return X, X2, lengthscale, variance
    counts = {X.shape[0], X2.shape[0]}
    if len(counts) != 2 or 1 not in counts:
        return X, X2, lengthscale, variance
    S = max(counts)
    operands = (X, X2, lengthscale, variance)
    if any(t is not None and (t.ndim == 0 or t.shape[0] not in (1, S))
           for t in operands):
        return operands
    return tuple(t if t is None or t.shape[0] == S
                 else t.expand((S,) + tuple(t.shape[1:])) for t in operands)
