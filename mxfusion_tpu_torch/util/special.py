"""Special linear-algebra functions.

Counterpart of ``mxfusion_tpu/util/special.py``. Every factorization is
``ops.linalg.cholesky``'s, so that a matrix that is not positive
definite gives NaN, as ``jnp.linalg.cholesky`` does.
"""
import math

import torch

from ..ops.linalg import cholesky


def log_determinant(A):
    """log|A| for SPD ``A`` (batched) via Cholesky."""
    L = cholesky(A)
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)


def log_multivariate_gamma(x, p):
    """Multivariate log-gamma ``log Γ_p(x)`` (batched over x)."""
    x = torch.as_tensor(x)
    j = torch.arange(1, p + 1, dtype=x.dtype, device=x.device)
    return (p * (p - 1) / 4.0) * math.log(math.pi) + torch.sum(
        torch.lgamma(x[..., None] + (1.0 - j) / 2.0), dim=-1)


def trace(A):
    """Batched trace over the last two axes."""
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)


def solve_posdef(A, b):
    """Solve ``A x = b`` for SPD ``A`` via Cholesky (batched)."""
    L = cholesky(A)
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def solve_triangular(L, b, lower=True, trans=False):
    """Batched triangular solve (thin wrapper for a single import site)."""
    if trans:
        L = L.mT
        lower = not lower
    return torch.linalg.solve_triangular(L, b, upper=not lower)
