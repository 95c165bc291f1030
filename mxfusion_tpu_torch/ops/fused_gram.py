"""Fused RBF gram -> L⁻¹ product for the SVGP data path.

Counterpart of ``mxfusion_tpu/ops/pallas_fused_gram.py``.
:func:`fused_linv_rbf_gram` computes ``G = Linv @ (var·exp(−½·|zs − xs|²))``
without the gram ``Kuf`` ever reaching device memory, and its backward
fuses the whole cotangent chain (dLinv, dZs, dXs, dvar) the same way.
On the card the forward is K2 and the backward is K3, hand-written CUDA
kernels on the TF32 tensor cores (``csrc/fused_gram.cu``: the forward
one launch, the backward three). On a CPU tensor the same
``autograd.Function`` runs the plain versions :func:`_fused_fwd_torch`
and :func:`_fused_bwd_torch`; the tests use that. A CUDA tensor
launches the kernels or raises: nothing falls back.

The gate. ``SVGPRegressionLogPdf`` engages the fused arm under the JAX
package's caller conditions (:func:`enabled`, wide N ≥ 4M, s = 1, the
exact ``RBF`` class, no ``active_dims``) and :func:`supported`, which
here means what the kernels take: a CUDA tensor, float32, D ≤ 128. The
JAX envelope (N ≥ 131072, M ≤ 512, M % 128 = 0) was measured on a TPU
and does not carry over. Precision, the TPU kernel's tiers as
``ops/precision.py`` maps them: the G-product at 3×TF32 (its HIGH,
3-pass bf16) and so the exponent's cross term Zs·Xsᵀ, the cotangent
products Uᵀ·dG and dG·Kᵀ and the D-wide de·Xs and deᵀ·Zs at 1-pass TF32
(its DEFAULT). The plain versions run every product at HIGHEST (IEEE
fp32).

``lower=True`` declares ``Linv`` lower triangular: the function is then
that of ``tril(Linv)``, its gradient with respect to ``Linv`` is lower
triangular, and the kernels skip the tiles above the diagonal. The SVGP
bound passes it (its L⁻¹ is ``triangular_inverse(L, lower=True)``).

Forward-mode AD cannot go through the Function (it has no ``jvp``, as
the JAX ``custom_vjp`` has none): wrap such traces in :func:`disabled`.
"""
import contextlib
import ctypes

import torch

from . import cuda_build
from .precision import einsum as p_einsum

# tiling of csrc/fused_gram.cu, checked against the library when it loads
TILE_ROWS = 128
TILE_COLS = 128
MAX_D = 128
# the backward splits dU = dG·Kᵀ over at most this many slices of N
MAX_DU_SLICES = 64
DU_SLICE_TARGET = 1024
# a slice starts on a whole k-chunk of K3b's ring (kChunk in the source), so
# every slice's dG rows stay 16-byte aligned where row 0 is
DU_SLICE_ALIGN = 32
BWD_LAUNCHES = 3  # K3a, K3b, K3c per backward call

_ENABLED = True
_LIB = None


def enabled():
    return _ENABLED


def set_enabled(flag):
    """Kill switch for the fused data path: ``set_enabled(False)`` makes
    the SVGP bound materialize Kuf everywhere."""
    global _ENABLED
    _ENABLED = bool(flag)


@contextlib.contextmanager
def disabled():
    """Materialize Kuf for the duration of the block. Needed around
    forward-mode AD (``torch.func.jvp``/``hessian``) of a bound inside
    the gate."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = False
    try:
        yield
    finally:
        _ENABLED = prev


def supported(M, N, D, dtype, device):
    """Whether the kernels take this call: a CUDA tensor, float32,
    1 ≤ D ≤ 128, any M ≥ 1 and N ≥ 1."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and M >= 1 and N >= 1 and 1 <= D <= MAX_D)


def du_slices(N):
    """``(slices, slice_len)``: how K3 splits N for the dU product. A
    function of N alone, so the reduction order is fixed per shape;
    ``slice_len`` is a multiple of ``DU_SLICE_ALIGN`` and no slice is
    empty."""
    slices = max(1, min(MAX_DU_SLICES, -(-N // DU_SLICE_TARGET)))
    slice_len = -(-N // (slices * DU_SLICE_ALIGN)) * DU_SLICE_ALIGN
    return -(-N // slice_len), slice_len


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _gram_torch(Zs, Xs, var):
    zn = 0.5 * torch.sum(Zs * Zs, dim=1)[:, None]
    xn = 0.5 * torch.sum(Xs * Xs, dim=1)[None, :]
    P = p_einsum("md,nd->mn", Zs, Xs)
    return var * torch.exp(torch.clamp(P - zn - xn, max=0.0))


def _fused_fwd_torch(Linv, Zs, Xs, var, lower=False):
    """Plain PyTorch forward: materializes K, then ``Linv @ K``
    (``tril(Linv) @ K`` under ``lower``)."""
    U = torch.tril(Linv) if lower else Linv
    return p_einsum("ij,jk->ik", U, _gram_torch(Zs, Xs, var))


#: the differentiable reference the tests hold the kernels to
reference_linv_rbf_gram = _fused_fwd_torch


def _fused_bwd_torch(Linv, Zs, Xs, var, dG, lower=False):
    """Plain PyTorch backward, K3's arithmetic written out: recompute K,
    dK = Uᵀ·dG, de = K∘dK, then dU = dG·Kᵀ, dZs = de·Xs − row(de)∘Zs,
    dXs = deᵀ·Zs − col(de)∘Xs and skv = Σde (dvar = skv/var). Under
    ``lower``, U = tril(Linv) and dU = tril(dG·Kᵀ), the exact gradient of
    the function of tril(Linv). The clamp's derivative is taken as 1, as
    the TPU kernel takes it."""
    K = _gram_torch(Zs, Xs, var)
    U = torch.tril(Linv) if lower else Linv
    de = K * p_einsum("mi,mn->in", U, dG)
    dU = p_einsum("mn,kn->mk", dG, K)
    if lower:
        dU = torch.tril(dU)
    dZs = p_einsum("kn,nd->kd", de, Xs) - torch.sum(de, dim=1)[:, None] * Zs
    dXs = p_einsum("kn,kd->nd", de, Zs) - torch.sum(de, dim=0)[:, None] * Xs
    return dU, dZs, dXs, torch.sum(de)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("fused_gram.cu")
        ptr = ctypes.c_void_p
        cint = ctypes.c_int
        lib.mxf_fused_gram_fwd_f32.argtypes = [ptr] * 5 + [cint] * 4 + [ptr]
        lib.mxf_fused_gram_fwd_f32.restype = cint
        lib.mxf_fused_gram_bwd_f32.argtypes = [ptr] * 14 + [cint] * 6 + [ptr]
        lib.mxf_fused_gram_bwd_f32.restype = cint
        lib.mxf_fused_gram_error_string.argtypes = [cint]
        lib.mxf_fused_gram_error_string.restype = ctypes.c_char_p
        for name in ("mxf_fused_gram_tile_rows", "mxf_fused_gram_tile_cols"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = cint
        lib.mxf_fused_gram_smem_bytes.argtypes = [cint, cint]
        lib.mxf_fused_gram_smem_bytes.restype = ctypes.c_longlong
        if (lib.mxf_fused_gram_tile_rows(), lib.mxf_fused_gram_tile_cols()) \
                != (TILE_ROWS, TILE_COLS):
            raise RuntimeError("csrc/fused_gram.cu tiles differ from "
                               "ops/fused_gram.py's TILE_ROWS/TILE_COLS")
        _LIB = lib
    return _LIB


def shared_memory_bytes(D):
    """Dynamic shared memory a block of K2, K3a and K3b takes at this D
    (nvcc's ptxas report shows static shared memory only)."""
    lib = _lib()
    return {name: lib.mxf_fused_gram_smem_bytes(i, D) for i, name in
            enumerate(("fused_fwd", "fused_bwd_de", "fused_bwd_du"))}


def _check(Linv, Zs, Xs, var, dG=None):
    M, D = Zs.shape if Zs.ndim == 2 else (-1, -1)
    N = Xs.shape[0] if Xs.ndim == 2 else -1
    shapes_ok = (Zs.ndim == 2 and Xs.ndim == 2 and Xs.shape[1] == D
                 and tuple(Linv.shape) == (M, M) and var.numel() == 1
                 and (dG is None or tuple(dG.shape) == (M, N)))
    if not shapes_ok:
        raise ValueError(
            "fused_linv_rbf_gram: Linv {}, Zs {}, Xs {}, var {}{} must be "
            "(M, M), (M, D), (N, D), one value{}.".format(
                tuple(Linv.shape), tuple(Zs.shape), tuple(Xs.shape),
                tuple(var.shape),
                "" if dG is None else ", dG {}".format(tuple(dG.shape)),
                "" if dG is None else ", (M, N)"))
    if not supported(M, N, D, Zs.dtype, Zs.device):
        raise ValueError(
            "fused_linv_rbf_gram: the CUDA kernels take float32 with "
            "1 <= D <= {}; got {} on {} with D = {}.".format(
                MAX_D, Zs.dtype, Zs.device, D))
    for name, t in (("Linv", Linv), ("Zs", Zs), ("Xs", Xs), ("var", var),
                    ("dG", dG)):
        if t is None:
            continue
        if t.device != Zs.device or t.dtype != torch.float32:
            raise ValueError("fused_linv_rbf_gram: {} is {} on {}; the "
                             "kernels take float32 on {}.".format(
                                 name, t.dtype, t.device, Zs.device))
        if not t.is_contiguous():
            raise ValueError("fused_linv_rbf_gram: {} must be contiguous."
                             .format(name))
    return M, N, D


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError("{} launch failed: {} ({})".format(
            what, _lib().mxf_fused_gram_error_string(err).decode(), err))


def _fwd_cuda(Linv, Zs, Xs, var, lower=False):
    """K2: one launch."""
    M, N, D = _check(Linv, Zs, Xs, var)
    G = torch.empty((M, N), dtype=torch.float32, device=Zs.device)
    lib = _lib()
    with torch.cuda.device(Zs.device):
        stream = torch.cuda.current_stream(Zs.device).cuda_stream
        err = lib.mxf_fused_gram_fwd_f32(
            Linv.data_ptr(), Zs.data_ptr(), Xs.data_ptr(), var.data_ptr(),
            G.data_ptr(), M, N, D, int(lower), stream)
    _raise_on(err, "fused_gram_fwd")
    _fwd_cuda.launches += 1
    return G


_fwd_cuda.launches = 0


def _bwd_cuda(Linv, Zs, Xs, var, dG, G, lower=False):
    """K3: three launches into fixed partial slots, then a fixed-order
    sum; returns (dU, dZs, dXs, skv). ``G`` is the forward's output: K3
    takes skv = Σ dG∘G, which equals Σ de (the TF32 rounding of dK would
    show in Σ de, whose terms cancel)."""
    M, N, D = _check(Linv, Zs, Xs, var, dG)
    if G.shape != dG.shape or G.dtype != dG.dtype or \
            G.device != dG.device or not G.is_contiguous():
        raise ValueError("fused_linv_rbf_gram: G must be the forward's "
                         "contiguous (M, N) float32 output.")
    n_tiles = -(-N // TILE_COLS)
    k_tiles = -(-M // TILE_ROWS)
    slices, slice_len = du_slices(N)
    f32 = dict(dtype=torch.float32, device=Zs.device)
    dU = torch.empty((M, M), **f32)
    dZs = torch.empty((M, D), **f32)
    dXs = torch.empty((N, D), **f32)
    skv = torch.empty((), **f32)
    pdU = torch.empty((slices, M, M), **f32)
    pdZs = torch.empty((n_tiles, M, D), **f32)
    pdXs = torch.empty((k_tiles, N, D), **f32)
    pskv = torch.empty((n_tiles,), **f32)
    lib = _lib()
    with torch.cuda.device(Zs.device):
        stream = torch.cuda.current_stream(Zs.device).cuda_stream
        err = lib.mxf_fused_gram_bwd_f32(
            Linv.data_ptr(), Zs.data_ptr(), Xs.data_ptr(), var.data_ptr(),
            dG.data_ptr(), G.data_ptr(), dU.data_ptr(), dZs.data_ptr(),
            dXs.data_ptr(), skv.data_ptr(), pdU.data_ptr(), pdZs.data_ptr(),
            pdXs.data_ptr(), pskv.data_ptr(), M, N, D, slices, slice_len,
            int(lower), stream)
    _raise_on(err, "fused_gram_bwd")
    _bwd_cuda.launches += BWD_LAUNCHES
    return dU, dZs, dXs, skv


_bwd_cuda.launches = 0


class _FusedLinvRbfGram(torch.autograd.Function):

    @staticmethod
    def forward(ctx, Linv, Zs, Xs, var, lower):
        ctx.lower = lower
        if Zs.device.type == "cpu":
            G = _fused_fwd_torch(Linv, Zs, Xs, var, lower)
        else:
            G = _fwd_cuda(Linv, Zs, Xs, var.reshape(()), lower)
        # K3 reads G back (skv = Σ dG∘G); saving the output copies nothing
        ctx.save_for_backward(Linv, Zs, Xs, var, G)
        return G

    @staticmethod
    def backward(ctx, dG):
        Linv, Zs, Xs, var, G = ctx.saved_tensors
        if Zs.device.type == "cpu":
            dU, dZs, dXs, skv = _fused_bwd_torch(Linv, Zs, Xs, var, dG,
                                                 ctx.lower)
        else:
            dU, dZs, dXs, skv = _bwd_cuda(Linv, Zs, Xs, var.reshape(()),
                                          dG.contiguous(), G, ctx.lower)
        return dU, dZs, dXs, (skv / var).reshape(var.shape), None


def fused_linv_rbf_gram(Linv, Zs, Xs, var, lower=False):
    """``G = Linv @ (var·exp(−½·|zs_m − xs_n|²))`` with Kuf never
    materialized on the card.

    ``Linv`` (M, M), typically L⁻¹ of chol(Kuu); ``Zs`` (M, D) and ``Xs``
    (N, D) lengthscale-scaled inputs; ``var`` the kernel variance (one
    value). Returns ``G`` (M, N). ``lower=True`` computes the function
    of ``tril(Linv)`` (the kernels skip the upper triangle); ``False`` is
    the JAX kernel's dense function. Differentiable in all four (K3 on
    the card); not twice, and not in forward mode.
    """
    if Zs.device.type not in ("cpu", "cuda"):
        raise ValueError("fused_linv_rbf_gram takes CPU or CUDA tensors, "
                         "got {}.".format(Zs.device))
    return _FusedLinvRbfGram.apply(Linv, Zs, Xs, var, bool(lower))
