"""Precision-pinned contractions for GP/linalg math.

Counterpart of ``mxfusion_tpu/ops/precision.py``: the HIGHEST tier.
Kernel matrices feed Cholesky factorizations, and a TF32 product (about
three decimal digits) perturbs K enough to make ``K + jitter·I``
indefinite. So every GP/MVN contraction goes through :func:`einsum`,
which runs in IEEE float32 on the card whatever the user has set with
``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision``. On the CPU float32 and float64
products are IEEE already and run as they are.

The data-side tiers and the guarded products come with training.
"""
from contextlib import contextmanager

import torch


@contextmanager
def ieee_fp32_matmul():
    """Run float32 matmuls inside the block without TF32, then restore
    the caller's setting. The setting is process-wide: a thread that
    changes it while the block runs races with the block."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def einsum(equation, *operands):
    if operands[0].is_cuda and operands[0].dtype == torch.float32:
        with ieee_fp32_matmul():
            return torch.einsum(equation, *operands)
    return torch.einsum(equation, *operands)
