"""Hand-written CUDA kernels for the GP hot path, with their plain versions.

Counterpart of ``mxfusion_tpu/ops/pallas_kernels.py``. The RBF gram
kernel (``csrc/rbf_gram.cu``) assembles ``K = var·exp(−½·r²)`` in one
pass: scaling by the lengthscale, the fp32 cross term, the clamp and
the exponential, then one store of K.

The gate is explicit. ``RBF._compute_K`` calls :func:`rbf_kernel_matrix`
when :func:`kernel_eligible` holds (the flag is on and the inputs are
float32). The wrapper then decides by device alone: a CUDA tensor
launches the kernel, or the wrapper raises on what the kernel does not
take; a CPU tensor takes the plain version :func:`_rbf_torch`, the
counterpart of ``_rbf_jnp``. Nothing falls back from the kernel to the
plain version.

The flag defaults to on. The JAX package turned its Pallas kernel off
after a TPU measurement; that measurement says nothing about this card.
"""
import ctypes

import torch

from . import cuda_build
from .precision import einsum as p_einsum

_USE_KERNEL = True
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
_TILE = 64            # output tile edge of csrc/rbf_gram.cu

_LIB = None


def set_use_kernel(flag):
    """Turn the CUDA RBF gram kernel on or off (on by default)."""
    global _USE_KERNEL
    _USE_KERNEL = bool(flag)


def use_kernel():
    return _USE_KERNEL


def kernel_eligible(X, X2):
    """Whether ``RBF._compute_K`` routes through :func:`rbf_kernel_matrix`:
    the flag is on and the inputs are float32."""
    return _USE_KERNEL and X.dtype == torch.float32 and \
        (X2 is None or X2.dtype == torch.float32)


def _rbf_torch(X, X2, lengthscale, variance):
    """Plain PyTorch RBF gram (the reference the kernel is held to)."""
    ls = torch.unsqueeze(lengthscale, -2)
    Xs = X / ls
    X2s = Xs if X2 is None else X2 / ls
    x1sq = torch.sum(torch.square(Xs), dim=-1)
    x2sq = torch.sum(torch.square(X2s), dim=-1)
    cross = p_einsum("...nd,...md->...nm", Xs, X2s)
    R2 = torch.clamp(x1sq[..., :, None] + x2sq[..., None, :] - 2.0 * cross,
                     min=0.0)
    return torch.unsqueeze(variance, -1) * torch.exp(-0.5 * R2)


def _rbf_lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("rbf_gram.cu")
        ptr = ctypes.c_void_p
        cint = ctypes.c_int
        lib.mxf_rbf_gram_f32.argtypes = [
            ptr, ptr, ptr, cint, ptr, ptr, cint, cint, cint, cint, ptr]
        lib.mxf_rbf_gram_f32.restype = ctypes.c_int
        lib.mxf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxf_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def rbf_kernel_matrix(X, X2, lengthscale, variance):
    """RBF gram ``K = var·exp(−½·max(|x|²+|x2|²−2x·x2, 0))`` on inputs
    divided by the lengthscale.

    ``X`` (s, N, D); ``X2`` (s, M, D) or None (then X2 = X);
    ``lengthscale`` (s, 1) or (s, D); ``variance`` (s, 1). Returns
    (s, N, M). CPU tensors take the plain version; CUDA tensors launch
    the kernel (float32, contiguous X and X2, no gradient) or raise.
    """
    if X.device.type == "cpu":
        return _rbf_torch(X, X2, lengthscale, variance)
    if X.device.type != "cuda":
        raise ValueError("rbf_kernel_matrix takes CPU or CUDA tensors, "
                         "got {}.".format(X.device))
    return _rbf_cuda(X, X2, lengthscale, variance)


rbf_kernel_matrix.launches = 0


def _rbf_cuda(X, X2, lengthscale, variance):
    operands = {"X": X, "X2": X2, "lengthscale": lengthscale,
                "variance": variance}
    for name, t in operands.items():
        if t is None:
            continue
        if t.device != X.device or t.dtype != torch.float32:
            raise ValueError(
                "rbf_kernel_matrix: {} is {} on {}; the CUDA kernel takes "
                "float32 tensors on one device ({}).".format(
                    name, t.dtype, t.device, X.device))
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(
                "the CUDA RBF gram kernel has no backward yet: call it "
                "under torch.no_grad(). Its gradient comes with the "
                "training slice.")
    X2_ = X if X2 is None else X2
    if X.ndim != 3 or X2_.ndim != 3 or X2_.shape[0] != X.shape[0] or \
            X2_.shape[2] != X.shape[2]:
        raise ValueError(
            "rbf_kernel_matrix: X {} and X2 {} must be (s, N, D) and "
            "(s, M, D).".format(tuple(X.shape), tuple(X2_.shape)))
    S, N, D = X.shape
    M = X2_.shape[1]
    if min(S, N, M, D) == 0:
        raise ValueError("rbf_kernel_matrix: empty input {} x {}.".format(
            tuple(X.shape), tuple(X2_.shape)))
    if S > _MAX_GRID_YZ or -(-N // _TILE) > _MAX_GRID_YZ:
        raise ValueError(
            "rbf_kernel_matrix: s = {} and ceil(N / {}) = {} must not "
            "exceed {} (CUDA grid limit).".format(
                S, _TILE, -(-N // _TILE), _MAX_GRID_YZ))
    if not X.is_contiguous() or not X2_.is_contiguous():
        raise ValueError("rbf_kernel_matrix: X and X2 must be contiguous.")
    ls = lengthscale.reshape(S, -1).contiguous()
    if ls.shape[1] not in (1, D):
        raise ValueError(
            "rbf_kernel_matrix: lengthscale {} must be (s, 1) or (s, {})."
            .format(tuple(lengthscale.shape), D))
    if variance.numel() != S:
        raise ValueError("rbf_kernel_matrix: variance {} must be (s, 1)."
                         .format(tuple(variance.shape)))
    var = variance.reshape(S).contiguous()
    K = torch.empty((S, N, M), dtype=torch.float32, device=X.device)
    lib = _rbf_lib()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.mxf_rbf_gram_f32(
            X.data_ptr(), X2_.data_ptr(), ls.data_ptr(), ls.shape[1],
            var.data_ptr(), K.data_ptr(), S, N, M, D, stream)
    if err != 0:
        raise RuntimeError("rbf_gram kernel launch failed: {} ({})".format(
            lib.mxf_cuda_error_string(err).decode(), err))
    rbf_kernel_matrix.launches += 1
    return K
