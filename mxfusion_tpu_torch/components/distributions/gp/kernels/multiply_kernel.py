"""Product of kernels.

Counterpart of ``mxfusion_tpu/components/distributions/gp/kernels/
multiply_kernel.py``: K and Kdiag are the elementwise products of the
sub-kernels'.
"""
from .kernel import CombinationKernel


class MultiplyKernel(CombinationKernel):
    def _compute_K(self, X, X2=None, **kernel_params):
        total = None
        for k in self.sub_kernels:
            Ki = k.K(X, X2=X2, **kernel_params)
            total = Ki if total is None else total * Ki
        return total

    def _compute_Kdiag(self, X, **kernel_params):
        total = None
        for k in self.sub_kernels:
            Ki = k.Kdiag(X, **kernel_params)
            total = Ki if total is None else total * Ki
        return total
