"""Linalg building blocks for the GP/inference stack.

Counterpart of ``mxfusion_tpu/ops/linalg.py``.
"""
import math

import torch


def _sym(A):
    return 0.5 * (A + A.transpose(-1, -2))


def _nan_lower(L, failed):
    """NaN in the lower triangle (diagonal included) of each matrix whose
    ``failed`` flag is set; the upper triangle stays 0. The NaN is added
    to L rather than put in its place, so that a gradient through a
    failed factor is NaN too, as it is through ``jnp.linalg.cholesky``'s
    (a substitution would hand the factorization a zero cotangent)."""
    n = L.shape[-1]
    lower = torch.ones((n, n), dtype=torch.bool, device=L.device).tril()
    nan = torch.full((), math.nan, dtype=L.dtype, device=L.device)
    return L + torch.where(failed[..., None, None] & lower, nan,
                           torch.zeros((), dtype=L.dtype, device=L.device))


def cholesky(A):
    """Cholesky of ``(..., n, n)`` with ``jnp.linalg.cholesky``'s
    convention: the factor of ½(A + Aᵀ), and a matrix that is not
    positive definite gives NaN in its lower triangle and 0 above it
    (``torch.linalg.cholesky`` raises instead). Every Cholesky of the GP
    path goes through it, so that a run whose Kuu loses definiteness sees
    a NaN loss, as in JAX, and does not die."""
    L, info = torch.linalg.cholesky_ex(_sym(A), check_errors=False)
    return _nan_lower(L, info > 0)


def make_diagonal(x):
    """Batched diag-embed: (..., N) -> (..., N, N)."""
    return torch.diag_embed(x)


def broadcast_to_w_samples(x, shape, num_samples):
    """Broadcast ``x`` to ``(num_samples,) + shape`` respecting the sample axis.

    ``x`` carries a leading sample axis (size 1 or num_samples); the
    remaining axes are right-aligned against ``shape`` and broadcast.
    """
    n_target = len(shape)
    n_source = x.ndim - 1
    if n_target - n_source > 0:
        t_shape = (x.shape[0],) + (1,) * (n_target - n_source) + \
            tuple(x.shape[1:])
        x = torch.reshape(x, t_shape)
    return torch.broadcast_to(x, (num_samples,) + tuple(shape))


def wide_triangular_solve(L, B, lower=True):
    """``L⁻¹·B`` for a right-hand side of any width.

    For N_rhs ≥ 4·M the JAX package forms ``L⁻¹`` once and applies it as
    a product (``linalg.py:36-61`` there); the port keeps that split so
    that the two packages round alike. The wide product is the data
    axis: its forward is floored at HIGH and its cotangents ride the
    data tier (:func:`~.precision.guarded_forward_matmul`)."""
    from .precision import guarded_forward_matmul
    if B.shape[-1] < 4 * L.shape[-1]:
        return torch.linalg.solve_triangular(L, B, upper=not lower)
    return guarded_forward_matmul(triangular_inverse(L, lower=lower), B)


def triangular_inverse(L, lower=True):
    """Explicit ``L⁻¹`` by one triangular solve against I (batched)."""
    M = L.shape[-1]
    eye = torch.eye(M, dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(
        L, torch.broadcast_to(eye, L.shape[:-2] + (M, M)), upper=not lower)


def cholesky_logdet(A):
    """(L, logdet) for SPD A via one Cholesky (batched)."""
    L = cholesky(A)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return L, logdet
