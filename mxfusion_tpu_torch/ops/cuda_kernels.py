"""Hand-written CUDA kernels for the GP hot path, with their plain versions.

Counterpart of ``mxfusion_tpu/ops/pallas_kernels.py``. The RBF gram
kernel (``csrc/rbf_gram.cu``) assembles ``K = var·exp(−½·r²)`` in one
pass: scaling by the lengthscale, the fp32 cross term, the clamp and
the exponential, then one store of K.

The gate is explicit. ``RBF._compute_K`` calls :func:`rbf_kernel_matrix`
when :func:`kernel_eligible` holds (the flag is on, the inputs are
float32 and of the shapes the kernel takes), after copying a stride-0
sample broadcast dense; other inputs take the plain branch. The wrapper
then decides by device alone: a CUDA tensor launches the kernel, or the
wrapper raises on what the kernel does not take; a CPU tensor takes the
plain version :func:`_rbf_torch`, the counterpart of ``_rbf_jnp``.
Nothing falls back from the kernel to the plain version.

The gradient is a :class:`torch.autograd.Function` on both devices:
its backward recomputes K through :func:`_rbf_torch` and differentiates
that, as the JAX ``_rbf_bwd`` (``pallas_kernels.py:168-176``)
recomputes through ``_rbf_jnp``. The JAX package has no backward kernel
for this gram, so neither has the port.

On the card the launch is the operator ``mxfusion_tpu_torch::rbf_gram``
(``torch.ops``, a CUDA kernel only, with a fake implementation that
gives the (s, N, M) float32 shape), so that ``torch.export`` records it
as one node of an exported program instead of tracing into its ctypes
call. The launch counter counts the operator's real launches, an
exported program's included.

The flag defaults to on. The JAX package turned its Pallas kernel off
after a TPU measurement; that measurement says nothing about this card.
"""
import ctypes

import torch

from . import cuda_build
from .precision import einsum as p_einsum

_USE_KERNEL = True
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
_TILE = 64            # rows of K per block of csrc/rbf_gram.cu (grid y)

_LIB = None


def set_use_kernel(flag):
    """Turn the CUDA RBF gram kernel on or off (on by default)."""
    global _USE_KERNEL
    _USE_KERNEL = bool(flag)


def use_kernel():
    return _USE_KERNEL


def kernel_eligible(X, X2, lengthscale=None, variance=None):
    """Whether ``RBF._compute_K`` routes through :func:`rbf_kernel_matrix`:
    the flag is on, the inputs are float32, and their shapes are what the
    kernel takes (:func:`_shape_error`). Inputs of any other rank or
    layout take the plain branch, as JAX's ``pallas_eligible`` sends
    them to ``_rbf_jnp``. Contiguity is not asked for: the caller copies
    a stride-0 sample broadcast dense."""
    if not _USE_KERNEL:
        return False
    operands = (X, X2, lengthscale, variance)
    if any(t is not None and t.dtype != torch.float32 for t in operands):
        return False
    return _shape_error(*operands) is None


def _shape_error(X, X2, lengthscale, variance):
    """Why the kernel does not take these shapes, or None: X (s, N, D)
    and X2 (s, M, D) or None, none of them empty, s and ceil(N / 64)
    within CUDA's grid limit, the lengthscale reshaping to (s, 1) or
    (s, D) and the variance to (s,)."""
    X2_ = X if X2 is None else X2
    if X.ndim != 3 or X2_.ndim != 3 or X2_.shape[0] != X.shape[0] or \
            X2_.shape[2] != X.shape[2]:
        return "X {} and X2 {} must be (s, N, D) and (s, M, D).".format(
            tuple(X.shape), tuple(X2_.shape))
    S, N, D = X.shape
    M = X2_.shape[1]
    if min(S, N, M, D) == 0:
        return "empty input {} x {}.".format(tuple(X.shape),
                                             tuple(X2_.shape))
    if S > _MAX_GRID_YZ or -(-N // _TILE) > _MAX_GRID_YZ:
        return "s = {} and ceil(N / {}) = {} must not exceed {} (CUDA " \
            "grid limit).".format(S, _TILE, -(-N // _TILE), _MAX_GRID_YZ)
    # a leading axis of s, so that a (1, D) lengthscale with D = s is not
    # read as s isotropic ones
    if lengthscale is not None and (
            lengthscale.ndim == 0 or lengthscale.shape[0] != S
            or lengthscale.numel() not in (S, S * D)):
        return "lengthscale {} must be (s, 1) or (s, {}).".format(
            tuple(lengthscale.shape), D)
    if variance is not None and (variance.ndim == 0 or variance.shape[0] != S
                                 or variance.numel() != S):
        return "variance {} must be (s, 1).".format(tuple(variance.shape))
    return None


def check_kernel_args(X, X2, lengthscale, variance):
    """Raise ``ValueError`` on what the CUDA kernel does not take: one
    device, float32, the shapes of :func:`_shape_error`, contiguous X and
    X2. :func:`_rbf_cuda` runs it before its launch."""
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
    error = _shape_error(X, X2, lengthscale, variance)
    if error is not None:
        raise ValueError("rbf_kernel_matrix: " + error)
    if not X.is_contiguous() or (X2 is not None and
                                 not X2.is_contiguous()):
        raise ValueError("rbf_kernel_matrix: X and X2 must be contiguous.")


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
    the kernel (float32, contiguous X and X2) or raise. Differentiable
    in every input (see :class:`_RbfGram`).
    """
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError("rbf_kernel_matrix takes CPU or CUDA tensors, "
                         "got {}.".format(X.device))
    return _RbfGram.apply(X, X2, lengthscale, variance)


rbf_kernel_matrix.launches = 0


class _RbfGram(torch.autograd.Function):
    """K1 with the gradient of its plain version. With ``X2 is None``
    both operand roles feed dX (the recomputation passes X twice)."""

    @staticmethod
    def forward(ctx, X, X2, lengthscale, variance):
        ctx.save_for_backward(X, X2, lengthscale, variance)
        if X.device.type == "cpu":
            return _rbf_torch(X, X2, lengthscale, variance)
        return torch.ops.mxfusion_tpu_torch.rbf_gram(X, X2, lengthscale,
                                                     variance)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        wanted = [t for t, need in zip(saved, ctx.needs_input_grad)
                  if need and t is not None]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(
                _rbf_torch(*saved), wanted, g,
                create_graph=torch.is_grad_enabled()))
        return tuple(next(grads) if need and t is not None else None
                     for t, need in zip(saved, ctx.needs_input_grad))


def _rbf_cuda(X, X2, lengthscale, variance):
    check_kernel_args(X, X2, lengthscale, variance)
    X2_ = X if X2 is None else X2
    S, N, D = X.shape
    M = X2_.shape[1]
    ls = lengthscale.reshape(S, -1).contiguous()
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


_LIB_OPS = torch.library.Library("mxfusion_tpu_torch", "FRAGMENT")
_LIB_OPS.define("rbf_gram(Tensor X, Tensor? X2, Tensor lengthscale, "
                "Tensor variance) -> Tensor")
# looked up at each call, so that a test can wrap the launch
_LIB_OPS.impl("rbf_gram", lambda X, X2, lengthscale, variance: _rbf_cuda(
    X, X2, lengthscale, variance), "CUDA")


@torch.library.register_fake("mxfusion_tpu_torch::rbf_gram", lib=_LIB_OPS)
def _rbf_gram_fake(X, X2, lengthscale, variance):
    check_kernel_args(X, X2, lengthscale, variance)
    M = (X if X2 is None else X2).shape[1]
    return X.new_empty((X.shape[0], X.shape[1], M), dtype=torch.float32)
