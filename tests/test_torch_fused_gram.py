"""K2 and K3 (the fused L⁻¹·Kuf gram and its backward) on the CPU: the
port's plain versions against the JAX package's Pallas kernels in
interpret mode and its reference, the backward against autograd, and a
pure-torch emulation of K3's partial buffers and fixed-order reduction
(``csrc/fused_gram.cu``), which the CUDA kernel itself cannot show here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxfusion_tpu.ops import pallas_fused_gram as pfg
from mxfusion_tpu_torch.ops import fused_gram as fg


@pytest.fixture
def interpret():
    pfg.set_interpret(True)
    yield
    pfg.set_interpret(False)


def _case(seed, M=128, N=2048, D=8, dtype=np.float32):
    """tests/ops/test_pallas_fused_gram.py's inputs: two grid tiles, a
    well-conditioned lower-triangular stand-in for L⁻¹."""
    rng = np.random.default_rng(seed)
    Zs = (rng.random((M, D)) * 3.0).astype(dtype)
    Xs = (rng.random((N, D)) * 3.0).astype(dtype)
    A = rng.standard_normal((M, M)).astype(dtype) * 0.05
    Linv = (np.tril(A) + np.eye(M, dtype=dtype)).astype(dtype)
    var = np.asarray(1.4, dtype)
    return Linv, Zs, Xs, var


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_forward_matches_jax_kernel_interpret(interpret):
    """float32, the kernels' bf16 splits being defined on float32;
    rtol 2e-4, atol 2e-5, the JAX kernel test's own (its 3-pass bf16
    products keep about f32 operand fidelity)."""
    Linv, Zs, Xs, var = _case(0)
    want_kernel = np.asarray(pfg.fused_linv_rbf_gram(
        jnp.asarray(Linv), jnp.asarray(Zs), jnp.asarray(Xs),
        jnp.asarray(var)))
    want_ref = np.asarray(pfg.reference_linv_rbf_gram(
        jnp.asarray(Linv), jnp.asarray(Zs), jnp.asarray(Xs),
        jnp.asarray(var)))
    got = fg._fused_fwd_torch(*_t(Linv, Zs, Xs, var)).numpy()
    assert got.shape == (128, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_kernel, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, want_ref, rtol=2e-4, atol=2e-5)


def test_backward_matches_jax_kernel_interpret(interpret):
    """K3's plain version against the JAX backward kernel, float32.
    Cotangents rtol 2e-3 (the JAX kernel runs them 1-pass bf16),
    atol 2e-5 as in the JAX kernel test."""
    Linv, Zs, Xs, var = _case(1)
    dG = (np.random.default_rng(7).standard_normal((128, 2048)) * 0.01
          ).astype(np.float32)
    jdU, jdZs, jdXs, jskv = pfg._call_bwd(
        jnp.asarray(Zs), jnp.asarray(Xs), jnp.asarray(Linv),
        jnp.reshape(jnp.asarray(var), (1, 1)), jnp.asarray(dG))
    dU, dZs, dXs, skv = fg._fused_bwd_torch(*_t(Linv, Zs, Xs, var, dG))
    for got, want, name in ((dU, jdU, "dU"), (dZs, jdZs, "dZs"),
                            (dXs, jdXs, "dXs"), (skv, jskv[0, 0], "skv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-5, err_msg=name)


def test_autograd_function_matches_jax_vjp(interpret):
    """The port's fused Function on CPU tensors (its plain versions)
    against ``jax.grad`` through the JAX kernels, probe as in the JAX
    kernel test; tolerances as above."""
    Linv, Zs, Xs, var = _case(1)
    probe = (np.random.default_rng(7).standard_normal((128, 2048)) * 0.01
             ).astype(np.float32)

    def jloss(L, Z, X, v):
        return jnp.sum(pfg.fused_linv_rbf_gram(L, Z, X, v) * probe)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in (Linv, Zs, Xs, var)])
    args = [t.requires_grad_(True) for t in _t(Linv, Zs, Xs, var)]
    before = (fg._fwd_cuda.launches, fg._bwd_cuda.launches)
    torch.sum(fg.fused_linv_rbf_gram(*args) * torch.as_tensor(probe)
              ).backward()
    assert (fg._fwd_cuda.launches, fg._bwd_cuda.launches) == before
    for a, g, name in zip(args, jg, ("dLinv", "dZs", "dXs", "dvar")):
        assert a.grad.shape == a.shape
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g),
                                   rtol=2e-3, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("M,N,D", [(128, 2048, 8), (37, 301, 5)])
def test_plain_backward_is_autograd_of_the_reference(M, N, D):
    """float64: K3's written-out arithmetic equals autograd of
    ``reference_linv_rbf_gram`` to 1e-10 (the clamp's derivative, taken
    as 1 by the kernels, never matters off coincident points)."""
    Linv, Zs, Xs, var = _t(*_case(2, M, N, D, np.float64))
    dG = torch.as_tensor(np.random.default_rng(3).standard_normal((M, N)))
    args = [t.clone().requires_grad_(True) for t in (Linv, Zs, Xs, var)]
    fg.reference_linv_rbf_gram(*args).backward(dG)
    dU, dZs, dXs, skv = fg._fused_bwd_torch(Linv, Zs, Xs, var, dG)
    for got, a in zip((dU, dZs, dXs, skv / var), args):
        np.testing.assert_allclose(got.numpy(), a.grad.numpy(),
                                   rtol=1e-10, atol=1e-10)


def _emulate_bwd(Linv, Zs, Xs, var, dG):
    """K3 as the CUDA kernels order it: per (k-tile × n-tile) block the
    partials of dZs, dXs and skv (K3a), per (slice of N) the partial of
    dU (K3b), then every output summed over its partials in slot order
    (K3c)."""
    M, N = dG.shape
    R, C = fg.TILE_ROWS, fg.TILE_COLS
    n_tiles, k_tiles = -(-N // C), -(-M // R)
    slices, slice_len = fg.du_slices(N)
    K = fg._gram_torch(Zs, Xs, var)
    de = K * (Linv.T @ dG)
    pdZs = torch.zeros((n_tiles, M, Zs.shape[1]), dtype=dG.dtype)
    pdXs = torch.zeros((k_tiles, N, Zs.shape[1]), dtype=dG.dtype)
    pskv = torch.zeros((k_tiles * n_tiles,), dtype=dG.dtype)
    for kt in range(k_tiles):
        ks = slice(kt * R, min(M, (kt + 1) * R))
        for nt in range(n_tiles):
            ns = slice(nt * C, min(N, (nt + 1) * C))
            t = de[ks, ns]
            pdZs[nt, ks] = t @ Xs[ns] - t.sum(1)[:, None] * Zs[ks]
            pdXs[kt, ns] = t.T @ Zs[ks] - t.sum(0)[:, None] * Xs[ns]
            pskv[kt * n_tiles + nt] = t.sum()
    pdU = torch.stack([dG[:, s * slice_len:(s + 1) * slice_len]
                       @ K[:, s * slice_len:(s + 1) * slice_len].T
                       for s in range(slices)])

    def in_order(parts):
        out = torch.zeros_like(parts[0])
        for p in parts:
            out = out + p
        return out

    return in_order(pdU), in_order(pdZs), in_order(pdXs), in_order(pskv)


def test_k3_reduction_order_emulation():
    """The partial-buffer layout and second pass of K3, emulated in
    float64 on a ragged shape with several tiles and dU slices, equal
    the plain backward to 1e-12 and are bitwise stable across calls."""
    M, N, D = 150, 4500, 3
    assert fg.du_slices(N)[0] > 1
    Linv, Zs, Xs, var = _t(*_case(4, M, N, D, np.float64))
    dG = torch.as_tensor(np.random.default_rng(5).standard_normal((M, N)))
    first = _emulate_bwd(Linv, Zs, Xs, var, dG)
    second = _emulate_bwd(Linv, Zs, Xs, var, dG)
    plain = fg._fused_bwd_torch(Linv, Zs, Xs, var, dG)
    for a, b, p in zip(first, second, plain):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_gate_and_switches():
    f32 = torch.float32
    assert fg.supported(512, 65536, 32, f32, "cuda")
    assert fg.supported(200, 5037, 7, f32, torch.device("cuda", 0))
    assert not fg.supported(512, 65536, 32, f32, "cpu")
    assert not fg.supported(512, 65536, 32, torch.float64, "cuda")
    assert not fg.supported(512, 65536, 129, f32, "cuda")
    assert fg.enabled()
    with fg.disabled():
        assert not fg.enabled()
    assert fg.enabled()
    fg.set_enabled(False)
    try:
        assert not fg.enabled()
    finally:
        fg.set_enabled(True)
    assert fg.du_slices(65536) == (32, 2048)
    assert fg.du_slices(100) == (1, 100)
    s, length = fg.du_slices(4500)
    assert s * length >= 4500 > (s - 1) * length


def test_wrapper_rejects_other_devices():
    x = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fg.fused_linv_rbf_gram(torch.zeros((4, 4), device="meta"), x, x,
                               torch.ones((), device="meta"))
