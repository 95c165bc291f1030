"""Precision-pinned contractions for GP/linalg math.

Counterpart of ``mxfusion_tpu/ops/precision.py``. The JAX package names
a precision per product (``Precision.HIGHEST``, ``HIGH``, ``DEFAULT``);
the port maps each tier to a float32 matmul precision of the card:

=============================  ======================  ================
tier                           JAX on the TPU          port on the card
=============================  ======================  ================
``einsum`` (HIGHEST)           f32 accumulation        IEEE fp32
guarded floor (HIGH)           3-pass bf16             IEEE fp32
data tier ``"default"``        1-pass bf16             TF32
data tier ``"high"``           3-pass bf16             IEEE fp32
data tier ``"highest"``        f32 accumulation        IEEE fp32
=============================  ======================  ================

On the CPU every tier is plain float32/float64, as in the JAX package.

Every product here is a :class:`torch.autograd.Function` whose forward
and backward each set their own precision, whatever the user has set
with ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision``: in JAX the transpose of a dot
keeps the dot's precision, so the cotangent products of a HIGHEST
product run at HIGHEST too. (A context manager around the forward alone
would leave the backward products, which autograd runs later, at the
user's setting.) The Function also defines ``jvp``, so
``torch.func.jvp`` works through every product (Laplace needs it).

Kernel matrices feed Cholesky factorizations, and a TF32 product (about
three decimal digits) perturbs K enough to make ``K + jitter·I``
indefinite; so every GP/MVN contraction goes through :func:`einsum`. The
data-side tiers, their guards and why each guarded site is guarded are
documented at the JAX counterpart (``precision.py:22-173``). The tiers
are read when a product runs (PyTorch runs eagerly); the backward
products use the tier that was set when their forward ran.

Traced by ``torch.export`` (or ``torch.compile``), the forward product
is the operator ``mxfusion_tpu_torch::tiered_einsum`` (``torch.ops``),
which takes its tier as an argument and pins it inside; run eagerly, it
is the same pinned einsum called directly. So the tier travels with each
product into an exported program: the graph records one call per
product, tier and all, and the program runs each product at its tier
whatever precision the process that serves it has set. (A precision
flipped around a plain einsum is a Python side effect, which an
exported graph does not record.)

The precision setting is process-wide: a thread that changes it while a
product runs races with the product.
"""
from contextlib import contextmanager

import torch

TIERS = ("default", "high", "highest")
# tier -> torch float32 matmul precision on a CUDA tensor
_CUDA_MATMUL = {"highest": "highest", "high": "highest", "default": "high"}

_DATA_PRECISION = "default"


@contextmanager
def _matmul_precision(name):
    """Run float32 matmuls inside the block at torch precision ``name``,
    then restore the caller's setting."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(name)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _pinned(tier, operand):
    # on the CPU every tier is IEEE; pinning "highest" there keeps a
    # global "medium" (bf16 on some CPUs) out of the GP math
    return _matmul_precision(
        _CUDA_MATMUL[tier] if operand.is_cuda else "highest")


def _pinned_einsum(equation, tier, A, B):
    with _pinned(tier, A):
        return torch.einsum(equation, A, B)


_LIB = torch.library.Library("mxfusion_tpu_torch", "FRAGMENT")
_LIB.define("tiered_einsum(Tensor A, Tensor B, str equation, str tier) "
            "-> Tensor")
_LIB.impl("tiered_einsum",
          lambda A, B, equation, tier: _pinned_einsum(equation, tier, A, B),
          "CompositeExplicitAutograd")


@torch.library.register_fake("mxfusion_tpu_torch::tiered_einsum", lib=_LIB)
def _tiered_einsum_fake(A, B, equation, tier):
    return torch.einsum(equation, A, B)


def _parse(equation):
    """``"ab,bc->ac"`` -> ("ab", "bc", "ac") with the ellipsis kept.
    Raises on what the hand-written transposes below do not cover."""
    if "->" not in equation:
        raise ValueError("precision einsum needs an explicit output: "
                         "{!r}".format(equation))
    ins, out = equation.replace(" ", "").split("->")
    terms = ins.split(",")
    if len(terms) != 2:
        raise ValueError("precision einsum takes two operands: {!r}"
                         .format(equation))
    a, b = terms
    letters = [t.replace("...", "") for t in (a, b, out)]
    for t in letters:
        if len(set(t)) != len(t):
            raise ValueError("repeated index in {!r}".format(equation))
    la, lb, lo = (set(t) for t in letters)
    if not la <= lb | lo or not lb <= la | lo:
        raise ValueError(
            "every index of {!r} must appear in the other operand or the "
            "output".format(equation))
    return a, b, out


def _sum_to(t, shape):
    """Reduce a broadcast gradient ``t`` to ``shape``."""
    lead = t.ndim - len(shape)
    if lead:
        t = t.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, (n, m) in enumerate(zip(shape, t.shape))
                 if n == 1 and m != 1)
    if dims:
        t = t.sum(dim=dims, keepdim=True)
    return t


class _TieredEinsum(torch.autograd.Function):
    """Two-operand einsum whose forward runs at ``fwd_tier`` and whose
    cotangent and tangent products run at ``bwd_tier``."""

    generate_vmap_rule = True  # torch.func.hessian vmaps over it

    @staticmethod
    def forward(equation, terms, fwd_tier, bwd_tier, A, B):
        if torch.compiler.is_compiling():
            # traced (torch.export, torch.compile): one operator node
            # that carries its tier
            return torch.ops.mxfusion_tpu_torch.tiered_einsum(
                A, B, equation, fwd_tier)
        return _pinned_einsum(equation, fwd_tier, A, B)

    @staticmethod
    def setup_context(ctx, inputs, output):
        equation, terms, _, bwd_tier, A, B = inputs
        ctx.terms = terms
        ctx.equation = equation
        ctx.bwd_tier = bwd_tier
        ctx.save_for_backward(A, B)
        ctx.save_for_forward(A, B)

    @staticmethod
    def backward(ctx, g):
        A, B = ctx.saved_tensors
        a, b, out = ctx.terms
        dA = dB = None
        with _pinned(ctx.bwd_tier, g):
            if ctx.needs_input_grad[4]:
                dA = _sum_to(torch.einsum(
                    "{},{}->{}".format(out, b, a), g, B), A.shape)
            if ctx.needs_input_grad[5]:
                dB = _sum_to(torch.einsum(
                    "{},{}->{}".format(a, out, b), A, g), B.shape)
        return None, None, None, None, dA, dB

    @staticmethod
    def jvp(ctx, _equation, _terms, _fwd, _bwd, tA, tB):
        A, B = ctx.saved_tensors
        out = None
        with _pinned(ctx.bwd_tier, A):
            if tA is not None:
                out = torch.einsum(ctx.equation, tA, B)
            if tB is not None:
                t = torch.einsum(ctx.equation, A, tB)
                out = t if out is None else out + t
        return out


def _tiered(equation, fwd_tier, bwd_tier, A, B):
    return _TieredEinsum.apply(equation, _parse(equation), fwd_tier,
                               bwd_tier, A, B)


def einsum(equation, *operands):
    """einsum at the HIGHEST tier, forward and backward, of one, two or
    three operands (JAX's takes ``*operands``). Three contract left to
    right through the two-operand tiered product, each pairwise product
    keeping the HIGHEST tier in both directions; one has no product and
    is a plain ``torch.einsum``."""
    if len(operands) == 2:
        return _tiered(equation, "highest", "highest", *operands)
    if len(operands) == 1:
        return torch.einsum(equation, operands[0])
    if len(operands) == 3:
        first, second = _split_three(equation)
        A, B, C = operands
        return _tiered(second, "highest", "highest",
                       _tiered(first, "highest", "highest", A, B), C)
    raise ValueError("precision einsum takes one, two or three operands, "
                     "got {}".format(len(operands)))


def _split_three(equation):
    """``"ab,bc,cd->ad"`` -> (``"ab,bc->ac"``, ``"ac,cd->ad"``): the
    first product keeps the indices of A and B that C or the output
    still needs, in their order of appearance (the ellipsis first)."""
    if "->" not in equation:
        raise ValueError("precision einsum needs an explicit output: "
                         "{!r}".format(equation))
    ins, out = equation.replace(" ", "").split("->")
    terms = ins.split(",")
    if len(terms) != 3:
        raise ValueError("equation {!r} does not have three operands"
                         .format(equation))
    a, b, c = terms
    later = set(c.replace("...", "")) | set(out.replace("...", ""))
    kept = ""
    for ch in (a + b).replace("...", ""):
        if ch in later and ch not in kept:
            kept += ch
    if "..." in a or "..." in b:
        kept = "..." + kept
    return "{},{}->{}".format(a, b, kept), "{},{}->{}".format(kept, c, out)


# --------------------------------------------------------------------------
# Data-side precision: contractions whose outputs feed only the bound's
# quadratic/reduction terms (the M x B products of the SVGP ELBO) and
# never a Cholesky. "default" (TF32 on the card) is the library default.
# --------------------------------------------------------------------------

def set_data_precision(precision):
    """Set the precision for data-side (non-Cholesky-feeding) GP
    contractions: "default" (the library default), "high", or
    "highest"."""
    global _DATA_PRECISION
    name = str(precision).lower()
    if name not in TIERS:
        raise ValueError("data precision must be one of {}, got {!r}."
                         .format(TIERS, precision))
    _DATA_PRECISION = name


def get_data_precision():
    return _DATA_PRECISION


def _guard(tier):
    return "high" if tier == "default" else tier


def data_einsum(equation, A, B):
    """einsum at the configured data-side precision, both directions."""
    return _tiered(equation, _DATA_PRECISION, _DATA_PRECISION, A, B)


def guarded_data_einsum(equation, A, B):
    """Data-side einsum that never drops below the HIGH floor, both
    directions: for the products whose rounding is amplified downstream
    (the residual path's Kufᵀw; ``precision.py:92-104`` there)."""
    tier = _guard(_DATA_PRECISION)
    return _tiered(equation, tier, tier, A, B)


def guarded_forward_matmul(A, B):
    """``A @ B`` with the forward product floored at HIGH and the
    cotangent (and tangent) products at the configured data precision.
    The asymmetry is the JAX package's measured split
    (``precision.py:107-152`` there): a relaxed forward L⁻¹Kuf poisons
    the bound's cancelling consumers, relaxed cotangents do not."""
    return _tiered("...ij,...jk->...ik", _guard(_DATA_PRECISION),
                   _DATA_PRECISION, A, B)


@contextmanager
def data_precision_scope(precision):
    """Temporarily force the data-side precision, e.g. to pin "highest"
    where a data-side product feeds a Cholesky."""
    global _DATA_PRECISION
    old = _DATA_PRECISION
    set_data_precision(precision)
    try:
        yield
    finally:
        _DATA_PRECISION = old
