"""Batched Cholesky of many small SPD matrices.

Counterpart of ``mxfusion_tpu/ops/pallas_batched_cholesky.py``. The
multivariate normals factor one small covariance (or precision) per data
point, so the factorization runs over a stack ``(B, n, n)`` with B in
the thousands and n at most 128. Hand-written CUDA kernels
(``csrc/batched_cholesky.cu``) do it:

- K4, :func:`_k4_cuda`, the counterpart of ``_kernel_v2`` (launched by
  ``_pallas_batched_cholesky_v2``): the right-looking factorization in
  the TPU kernel's scaled column order. For n ≤ 64 one warp owns a
  matrix in registers, several matrices to a block; for 64 < n ≤ 128
  one block owns it, each thread an 8 × 8 register tile of its lower
  triangle. Both do the same operations on the same values, so they
  give the same bits. It carries
  :func:`batched_cholesky` and :func:`cholesky`, which the MVN family
  calls.
- K5, :func:`_k5_cuda`, the counterpart of the r3 ``_kernel`` (launched
  by ``_pallas_batched_cholesky``): the same factorization in the
  left-looking column order, rows in registers dotted with row j of a
  shared tile: a warp per matrix for n ≤ 64, four warps (a row per lane)
  above.
  :func:`batched_cholesky_r3` reaches it;
  nothing in the library does, as in the JAX package.

The plain version of both is the GP path's :func:`.linalg.cholesky`:
``torch.linalg.cholesky_ex`` with the JAX convention for a matrix that
is not positive definite: its lower triangle is NaN
(``jnp.linalg.cholesky`` returns NaN, ``torch.linalg.cholesky``
raises). The kernels give the same pattern. All of them factor ½(A + Aᵀ), as
``jnp.linalg.cholesky`` does (LAPACK's ``potrf`` and
``torch.linalg.cholesky`` read the lower triangle alone), so that the
symmetric gradient of the custom backward is the derivative of the
forward in every entry.

The gate :func:`supported` is what the kernels take: a CUDA tensor,
float32, a square (B, n, n) stack with 1 ≤ n ≤ 128. The JAX envelope
(B ≥ 256 or 64, n % 8 = 0) was measured on a TPU and does not carry
over. Inside the gate a CUDA tensor launches K4 or raises; outside it
the plain version runs, as JAX runs ``jnp.linalg.cholesky``.

The gradient of :func:`batched_cholesky` is an ``autograd.Function``
whose backward is the JAX ``_bwd`` (``pallas_batched_cholesky.py:242``):
P = Φ(Lᵀ·dL), two triangular solves, then symmetrize. It applies to
whichever forward ran.
"""
import ctypes
import math

import torch

from . import cuda_build
from . import linalg
from .linalg import _nan_lower, _sym
from .precision import einsum as p_einsum

MAX_N = 128  # the largest n whose working matrix csrc/batched_cholesky.cu holds

_LIB = None


def supported(shape, dtype, device):
    """Whether K4 takes a stack of this shape: a CUDA tensor, float32,
    (B, n, n) with B ≥ 1 and 1 ≤ n ≤ 128."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and len(shape) == 3 and shape[1] == shape[2]
            and 1 <= shape[2] <= MAX_N and shape[0] >= 1)


def _phi(X):
    """Lower triangle with the diagonal halved (Cholesky-grad helper);
    ``mxfusion_tpu/ops/blocked_cholesky.py:81-85``."""
    return torch.tril(X) - 0.5 * torch.diag_embed(
        torch.diagonal(X, dim1=-2, dim2=-1))


# ---------------------------------------------------------------------------
# the kernels' column orders written out
# ---------------------------------------------------------------------------

def _k4_emulate(A):
    """K4's column order in plain PyTorch (the TPU kernel's scaled
    right-looking column, with √ and a division where JAX takes
    ``rsqrt``): at column j, d = √W[j, j], inv = 1/d, c_i = W[i, j]·inv
    for i > j, L[j, j] = d and L[i, j] = c_i, then W[i, k] −= c_i·c_k
    over the symmetric trailing block i, k > j (the warp kernel updates
    both halves of it, the block kernel the lower one, on the same
    values). A pivot that is not positive marks the matrix as failed
    (NaN lower triangle). It follows K4's order but not its rounding:
    the kernels update by ``fmaf(-c_i, c_k, W[i, k])``, one rounding,
    where this multiplies and then subtracts, two; so its float32 bits
    are not the kernel's (``tests/test_torch_cuda_kernels.py`` holds
    the kernel's own bits on the card)."""
    W = _sym(A).clone()
    n = A.shape[-1]
    L = torch.zeros_like(W)
    failed = torch.zeros(A.shape[:-2], dtype=torch.bool, device=A.device)
    for j in range(n):
        p = W[..., j, j]
        failed = failed | ~(p > 0)
        d = torch.sqrt(p)
        c = W[..., j + 1:, j] * (1.0 / d)[..., None]
        L[..., j, j] = d
        L[..., j + 1:, j] = c
        W[..., j + 1:, j + 1:] -= c[..., :, None] * c[..., None, :]
    return _nan_lower(L, failed)


def _k5_emulate(A):
    """K5's arithmetic in plain PyTorch, in its order (left-looking): at
    column j, s_i = A[i, j] − Σ_{k<j} L[i, k]·L[j, k] for i ≥ j, the
    products subtracted from A[i, j] in k order, as the kernel's dot of
    row i with row j of its tile T (−L below the diagonal); d = √s_j,
    L[i, j] = s_i/d. A pivot s_j that is not positive marks the matrix as
    failed. It follows K5's order but not its rounding: the kernel takes
    each product and its subtraction in one ``fmaf``, this multiplies and
    then subtracts."""
    A = _sym(A)
    n = A.shape[-1]
    L = torch.zeros_like(A)
    failed = torch.zeros(A.shape[:-2], dtype=torch.bool, device=A.device)
    for j in range(n):
        s = A[..., j:, j]
        for k in range(j):
            s = s - L[..., j:, k] * L[..., j, None, k]
        failed = failed | ~(s[..., 0] > 0)
        d = torch.sqrt(s[..., 0])
        L[..., j, j] = d
        L[..., j + 1:, j] = s[..., 1:] / d[..., None]
    return _nan_lower(L, failed)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("batched_cholesky.cu")
        ptr = ctypes.c_void_p
        cint = ctypes.c_int
        for name in ("mxf_batched_cholesky_f32", "mxf_batched_cholesky_r3_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, cint, cint, ptr]
            fn.restype = cint
        lib.mxf_batched_cholesky_max_n.argtypes = []
        lib.mxf_batched_cholesky_max_n.restype = cint
        lib.mxf_batched_cholesky_smem_bytes.argtypes = [cint, cint]
        lib.mxf_batched_cholesky_smem_bytes.restype = ctypes.c_longlong
        lib.mxf_batched_cholesky_per_block.argtypes = [cint]
        lib.mxf_batched_cholesky_per_block.restype = cint
        lib.mxf_batched_cholesky_error_string.argtypes = [cint]
        lib.mxf_batched_cholesky_error_string.restype = ctypes.c_char_p
        if lib.mxf_batched_cholesky_max_n() != MAX_N:
            raise RuntimeError("csrc/batched_cholesky.cu holds n <= {}, "
                               "ops/batched_cholesky.py says {}".format(
                                   lib.mxf_batched_cholesky_max_n(), MAX_N))
        _LIB = lib
    return _LIB


def shared_memory_bytes(n, variant=4):
    """Dynamic shared memory a block of K4 (``variant`` 4) or K5 (5)
    takes at this n."""
    return int(_lib().mxf_batched_cholesky_smem_bytes(n, variant))


def matrices_per_block(n):
    """Matrices one block of K4 or K5 factors at this n (a warp each for
    n ≤ 64)."""
    return int(_lib().mxf_batched_cholesky_per_block(n))


def _launch(symbol, what, A):
    if not supported(tuple(A.shape), A.dtype, A.device):
        raise ValueError(
            "{}: the CUDA kernel takes a float32 (B, n, n) stack on the "
            "card with 1 <= n <= {}; got {} {} on {}.".format(
                what, MAX_N, A.dtype, tuple(A.shape), A.device))
    if not A.is_contiguous():
        raise ValueError("{}: the stack must be contiguous (a broadcast "
                         "view is copied by reshape first).".format(what))
    B, n, _ = A.shape
    L = torch.empty_like(A)
    lib = _lib()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = getattr(lib, symbol)(A.data_ptr(), L.data_ptr(), B, n, stream)
    if err != 0:
        raise RuntimeError("{} launch failed: {} ({})".format(
            what, lib.mxf_batched_cholesky_error_string(err).decode(), err))
    return L


def _k4_cuda(A):
    """K4 on a contiguous float32 (B, n, n) CUDA stack: one launch."""
    L = _launch("mxf_batched_cholesky_f32", "batched_cholesky (K4)", A)
    _k4_cuda.launches += 1
    return L


_k4_cuda.launches = 0


def _k5_cuda(A):
    """K5 on a contiguous float32 (B, n, n) CUDA stack: one launch."""
    L = _launch("mxf_batched_cholesky_r3_f32", "batched_cholesky_r3 (K5)", A)
    _k5_cuda.launches += 1
    return L


_k5_cuda.launches = 0


class _BatchedCholesky(torch.autograd.Function):
    """K4 inside the gate, the plain version outside it; the backward is
    JAX's ``_bwd`` for both."""

    @staticmethod
    def forward(ctx, A):
        if supported(tuple(A.shape), A.dtype, A.device):
            L = _k4_cuda(A.contiguous())
        else:
            L = linalg.cholesky(A)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, dL):
        L, = ctx.saved_tensors
        P = _phi(p_einsum("...ji,...jk->...ik", L, dL))
        Lt = L.transpose(-1, -2)
        S = torch.linalg.solve_triangular(Lt, P, upper=True)
        S = torch.linalg.solve_triangular(
            Lt, S.transpose(-1, -2), upper=True).transpose(-1, -2)
        return 0.5 * (S + S.transpose(-1, -2))


def batched_cholesky(A):
    """Cholesky of a stack ``(B, n, n)`` of small SPD matrices: K4 on the
    card inside :func:`supported`, the plain version elsewhere.
    Differentiable (JAX's custom backward)."""
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError("batched_cholesky takes CPU or CUDA tensors, got "
                         "{}.".format(A.device))
    return _BatchedCholesky.apply(A)


def cholesky(A):
    """Drop-in ``torch.linalg.cholesky`` that takes K4 when the leading
    dims flatten into a stack the kernel takes (the MVN family's
    runtime covariances are (samples, ..., D, D)). The flattening
    ``reshape`` copies a broadcast (stride-0) view into a dense stack.
    Elsewhere, and for ``ndim < 3``, the plain version."""
    if A.ndim < 3:
        return linalg.cholesky(A)
    n = A.shape[-1]
    B = math.prod(A.shape[:-2])
    if not supported((B, A.shape[-2], n), A.dtype, A.device):
        return linalg.cholesky(A)
    return batched_cholesky(A.reshape(B, A.shape[-2], n)).reshape(A.shape)


def batched_cholesky_r3(A):
    """The r3 variant (counterpart of ``_pallas_batched_cholesky``): K5
    on a CUDA tensor, or it raises on what K5 does not take; the plain
    version on a CPU tensor. Not differentiable, as in JAX."""
    if A.device.type == "cpu":
        return linalg.cholesky(A)
    if A.device.type != "cuda":
        raise ValueError("batched_cholesky_r3 takes CPU or CUDA tensors, "
                         "got {}.".format(A.device))
    return _k5_cuda(A)
