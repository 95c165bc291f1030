"""The batched Cholesky (K4, K5) against the JAX package, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda_kernels.py``
holds them against the plain version there). Here the JAX kernels run in
the Pallas interpreter, and the port's pure-torch emulations of the two
kernels' column orders (``_k4_emulate``: right-looking, one rank-1
update per column; ``_k5_emulate``: left-looking) and its plain version
are held to them, at the JAX test's shapes and tolerance
(``tests/ops/test_cholesky_variants.py:88-104``: 5e-6 of max |L| in
float32). Then the custom backward, the NaN convention for a matrix that
is not positive definite, and the dispatch.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxfusion_tpu.ops import batched_cholesky as jbatched_cholesky
from mxfusion_tpu.ops.pallas_batched_cholesky import (
    _pallas_batched_cholesky, _pallas_batched_cholesky_v2)

from mxfusion_tpu_torch.ops import linalg

# the module (ops.batched_cholesky is the function, as in JAX)
bc = importlib.import_module("mxfusion_tpu_torch.ops.batched_cholesky")

# (B, n, JAX chunk): K4's block tier at n = 96 and at n = 100 (n % 4 != 0)
SHAPES = [(32, 64, 16), (24, 128, 16), (40, 32, 16), (16, 96, 8),
          (12, 100, 8)]


def _spd(shape, scale, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal(shape).astype(dtype)
    n = shape[-1]
    return W @ np.swapaxes(W, -1, -2) + scale * np.eye(n, dtype=dtype)


def _rel(L, ref):
    return float(np.abs(np.asarray(L) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("B,n,c", SHAPES)
@pytest.mark.parametrize("variant", ["K4", "K5"])
def test_port_matches_the_jax_kernel(variant, B, n, c):
    """K4 against ``_kernel_v2``, K5 against the r3 ``_kernel``, both in
    the Pallas interpreter (24 = a ragged last chunk of 16, 12 of 8):
    the port's emulation of the kernel and its plain version are within
    5e-6 of max |L| of the JAX kernel, whose upper triangle is exactly 0,
    as theirs is."""
    A = _spd((B, n, n), n, seed=5, dtype=np.float32)
    jax_kernel = _pallas_batched_cholesky_v2 if variant == "K4" else \
        _pallas_batched_cholesky
    LJ = np.asarray(jax_kernel(jnp.asarray(A), c, interpret=True))
    emulate = bc._k4_emulate if variant == "K4" else bc._k5_emulate
    At = torch.as_tensor(A)
    for L in (emulate(At), linalg.cholesky(At)):
        L = L.numpy()
        assert L.dtype == np.float32
        assert _rel(L, LJ) < 5e-6
        assert np.all(np.triu(L, 1) == 0.0)
    assert np.all(np.triu(LJ, 1) == 0.0)
    assert _rel(LJ, np.linalg.cholesky(A.astype(np.float64))) < 5e-6


@pytest.mark.parametrize("n", [1, 2, 7, 33, 64, 65, 96, 100, 128])
def test_emulations_match_the_plain_version_in_float64(n):
    """Any n up to the kernels' 128, ragged included, on both sides of
    K4's tiers (the warp kernel up to 32 and 64, the tile kernel above):
    the two column orders give the same factor to 1e-12 in float64."""
    A = torch.as_tensor(_spd((3, n, n), n, seed=n))
    ref = linalg.cholesky(A)
    for emulate in (bc._k4_emulate, bc._k5_emulate):
        torch.testing.assert_close(emulate(A), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,N", [(1, 32), (20, 32), (33, 64), (60, 64),
                                 (96, 128), (100, 128)])
def test_identity_padding_leaves_the_factor_unchanged(n, N):
    """K4's warp kernel factors an n x n matrix inside an N x N tile
    padded by the identity: in K4's column order the leading n x n block
    of the padded factor is the factor itself, bit for bit in float32,
    and the padding's factor is the identity. (The emulation rounds its
    update twice where the kernel's ``fmaf`` rounds once; the padding
    adds exact zeros either way. The kernel's own bits are held on the
    card in ``test_cuda_identity_padding_gives_the_same_bits``.)"""
    A = torch.as_tensor(_spd((5, n, n), n, seed=n, dtype=np.float32))
    P = torch.eye(N, dtype=A.dtype).repeat(5, 1, 1)
    P[:, :n, :n] = A
    LP = bc._k4_emulate(P)
    assert torch.equal(LP[:, :n, :n], bc._k4_emulate(A))
    assert torch.equal(LP[:, n:, n:],
                       torch.eye(N - n, dtype=A.dtype).expand(5, -1, -1))
    assert bool((LP[:, n:, :n] == 0).all())


def test_custom_gradient_matches_jax_and_torch():
    """The custom backward (JAX's ``_bwd``: Φ(Lᵀ·dL), two triangular
    solves, symmetrize) against JAX's ``batched_cholesky`` gradient and
    against ``torch.linalg.cholesky``'s own, in float64 at (8, 32, 32);
    the symmetrized cotangents g + gᵀ at rtol 1e-9, as the JAX test
    compares them (``test_cholesky_variants.py:66-74``)."""
    A = _spd((8, 32, 32), 32, seed=3)
    gj = np.asarray(jax.grad(
        lambda a: jnp.sum(jnp.sin(jbatched_cholesky(a))))(jnp.asarray(A)))

    def torch_grad(fn):
        a = torch.as_tensor(A).requires_grad_(True)
        torch.sum(torch.sin(fn(a))).backward()
        return a.grad.numpy()

    g = torch_grad(bc.batched_cholesky)
    gt = torch_grad(torch.linalg.cholesky)

    def sym(x):
        return x + np.swapaxes(x, -1, -2)

    np.testing.assert_allclose(sym(g), sym(gj), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(sym(g), sym(gt), rtol=1e-9, atol=1e-11)
    # the custom backward returns the symmetric half-sum itself
    np.testing.assert_allclose(g, np.swapaxes(g, -1, -2), rtol=0, atol=0)


def test_gradient_through_cholesky_of_a_broadcast_stack():
    """``cholesky`` of a broadcast (stride-0) view: the reshape copies it
    dense, and the gradient sums over the broadcast axis, as JAX's
    ``broadcast_to`` gradient does."""
    A = _spd((1, 5, 6, 6), 6, seed=7)
    C = np.random.default_rng(8).standard_normal((4, 5, 6, 6))

    def port(a):
        a = torch.as_tensor(a).requires_grad_(True)
        L = bc.cholesky(a.expand(4, 5, 6, 6))
        torch.sum(L * torch.as_tensor(C)).backward()
        return L.detach().numpy(), a.grad.numpy()

    def jaxs(a):
        f = lambda a: jnp.sum(jnp.linalg.cholesky(
            jnp.broadcast_to(a, (4, 5, 6, 6))) * C)
        return np.asarray(jnp.linalg.cholesky(jnp.broadcast_to(
            a, (4, 5, 6, 6)))), np.asarray(jax.grad(f)(jnp.asarray(a)))

    L, g = port(A)
    LJ, gj = jaxs(A)
    np.testing.assert_allclose(L, LJ, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(g + np.swapaxes(g, -1, -2),
                               gj + np.swapaxes(gj, -1, -2), rtol=1e-9,
                               atol=1e-12)


def test_not_positive_definite_gives_jax_nan_pattern():
    """One indefinite and one negative-definite matrix in a batch: the
    plain version, both emulations, ``cholesky`` and ``batched_cholesky``
    give JAX's result, NaN in the whole lower triangle of those two
    matrices and 0 above it, and the other matrices unchanged. (The
    kernels are held to the same pattern on the card.)"""
    A = _spd((5, 4, 4), 4, seed=9)
    A[1] = np.array([[1., 2., 0., 0.], [2., 1., 0., 0.],
                     [0., 0., 1., 0.], [0., 0., 0., 1.]])
    A[3] = -A[3]
    LJ = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    assert np.isnan(LJ[1]).sum() == np.isnan(LJ[3]).sum() == 10
    for fn in (linalg.cholesky, bc._k4_emulate, bc._k5_emulate,
               bc.cholesky, bc.batched_cholesky, bc.batched_cholesky_r3):
        L = fn(torch.as_tensor(A)).numpy()
        np.testing.assert_array_equal(np.isnan(L), np.isnan(LJ),
                                      err_msg=fn.__name__)
        np.testing.assert_allclose(L, LJ, rtol=1e-12, atol=1e-14,
                                   equal_nan=True, err_msg=fn.__name__)
        assert np.all(np.triu(L, 1) == 0.0)


@pytest.mark.parametrize("shape,dtype,device,ok", [
    ((2048, 64, 64), torch.float32, "cuda", True),
    ((1, 1, 1), torch.float32, "cuda", True),
    ((3, 128, 128), torch.float32, "cuda", True),
    ((3, 129, 129), torch.float32, "cuda", False),
    ((3, 64, 64), torch.float64, "cuda", False),
    ((3, 64, 64), torch.float32, "cpu", False),
    ((3, 64, 32), torch.float32, "cuda", False),
    ((64, 64), torch.float32, "cuda", False),
    ((0, 8, 8), torch.float32, "cuda", False)])
def test_gate_is_what_the_kernel_takes(shape, dtype, device, ok):
    """CUDA + float32 + a square (B, n, n) stack with 1 <= n <= 128, any
    B >= 1: no TPU thresholds (B >= 256, n % 8 = 0)."""
    assert bc.supported(shape, dtype, device) == ok


def test_cpu_tensors_take_the_plain_version():
    """On the CPU nothing launches: ``cholesky`` of any rank and both
    entries give the plain result; the kernel wrappers themselves refuse
    a CPU tensor, and another device type is refused up front."""
    A = torch.as_tensor(_spd((2, 3, 5, 5), 5, seed=11), dtype=torch.float32)
    k4, k5 = bc._k4_cuda.launches, bc._k5_cuda.launches
    ref = linalg.cholesky(A)
    assert torch.equal(bc.cholesky(A), ref)
    assert torch.equal(bc.cholesky(A[0, 0]), ref[0, 0])
    assert torch.equal(bc.batched_cholesky(A[0]), ref[0])
    assert torch.equal(bc.batched_cholesky_r3(A[0]), ref[0])
    assert (bc._k4_cuda.launches, bc._k5_cuda.launches) == (k4, k5)
    for wrapper in (bc._k4_cuda, bc._k5_cuda):
        with pytest.raises(ValueError, match="float32"):
            wrapper(A[0])
    meta = torch.zeros((2, 4, 4), device="meta")
    for fn in (bc.batched_cholesky, bc.batched_cholesky_r3):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(meta)
