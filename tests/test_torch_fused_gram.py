"""K2 and K3 (the fused L⁻¹·Kuf gram and its backward) on the CPU: the
port's plain versions against the JAX package's Pallas kernels in
interpret mode and its reference, the backward against autograd, the
``lower`` flag against the function of ``tril(Linv)``, and pure-torch
emulations of the CUDA kernels' algorithm (``csrc/fused_gram.cu``): the
``cvt.rna.tf32.f32`` rounding, the gram's 3×TF32 cross term, K2's tiles,
triangle skip and 3×TF32 product, K3's 1-pass TF32 products, partial
slots and fixed-order reduction. The CUDA kernels themselves cannot run here."""
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


def _tf32_rna(x):
    """``cvt.rna.tf32.f32`` on a float32 tensor: round to nearest with
    ties away from zero, to 10 mantissa bits (the low 13 bits cleared);
    infinities and NaNs pass through."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = bits & 0x80000000
    mag = bits & 0x7FFFFFFF
    rounded = torch.where(mag >= 0x7F800000, mag,
                          (mag + 0x1000) & 0x7FFFE000)
    out = sign | rounded
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


def _tiles(n, size):
    return [slice(i, min(n, i + size)) for i in range(0, n, size)]


def _3xtf32(A, B):
    """A·Bᵀ as the kernels' 3×TF32 products: hi = rna(a), lo =
    rna(a − hi), A_lo·B_hiᵀ + A_hi·B_loᵀ + A_hi·B_hiᵀ in float32."""
    Ah, Bh = _tf32_rna(A), _tf32_rna(B)
    Al, Bl = _tf32_rna(A - Ah), _tf32_rna(B - Bh)
    return Al @ Bh.T + Ah @ Bl.T + Ah @ Bh.T


def _emulate_gram(Zs, Xs, var):
    """The gram as all three kernels build it: the cross term Zs·Xsᵀ at
    3×TF32 on the tensor cores, the half norms in float32, the exponent
    clamped at 0."""
    zn = 0.5 * torch.sum(Zs * Zs, dim=1)[:, None]
    xn = 0.5 * torch.sum(Xs * Xs, dim=1)[None, :]
    return var * torch.exp(torch.clamp(_3xtf32(Zs, Xs) - zn - xn, max=0.0))


def _emulate_fwd(Linv, Zs, Xs, var, lower):
    """K2 as the CUDA kernel computes it, in float32: the kernels' gram,
    U and K split into tf32 hi and lo, per 128-row tile of G the products
    U_lo·K_hi + U_hi·K_lo + U_hi·K_hi over the k-tiles the tile needs
    (under ``lower``, none above the diagonal, and tril(U) inside)."""
    M = Linv.shape[0]
    U = torch.tril(Linv) if lower else Linv
    K = _emulate_gram(Zs, Xs, var)
    Uh, Kh = _tf32_rna(U), _tf32_rna(K)
    Ul, Kl = _tf32_rna(U - Uh), _tf32_rna(K - Kh)
    G = torch.empty((M, Xs.shape[0]), dtype=torch.float32)
    for rows in _tiles(M, fg.TILE_ROWS):
        ks = slice(0, rows.stop if lower else M)
        G[rows] = Ul[rows, ks] @ Kh[ks] + Uh[rows, ks] @ Kl[ks] \
            + Uh[rows, ks] @ Kh[ks]
    return G


def _emulate_bwd(Linv, Zs, Xs, var, dG, G, lower=False, tf32=True):
    """K3 as the CUDA kernels order it: dK = Uᵀ·dG (K3a's main loop,
    under ``lower`` over m ≥ k of tril(U)), de = K∘dK, per (k-tile ×
    n-tile) block the partials of dZs and dXs, per n-tile the partial of
    skv = Σ dG∘G from the forward's G (K3a), per slice of N the partial
    of dU (K3b), then every output summed over its partials in slot
    order, with the upper triangle of dU 0 under ``lower`` (K3c).
    ``tf32`` rounds the operands of the products and builds the gram as
    the kernels do."""
    r = _tf32_rna if tf32 else (lambda t: t)
    M, N = dG.shape
    K = _emulate_gram(Zs, Xs, var) if tf32 else fg._gram_torch(Zs, Xs, var)
    U = torch.tril(Linv) if lower else Linv
    de = K * (r(U).T @ r(dG))
    k_tiles, n_tiles = _tiles(M, fg.TILE_ROWS), _tiles(N, fg.TILE_COLS)
    pdZs = torch.zeros((len(n_tiles), M, Zs.shape[1]), dtype=dG.dtype)
    pdXs = torch.zeros((len(k_tiles), N, Zs.shape[1]), dtype=dG.dtype)
    pskv = torch.stack([torch.sum(dG[:, ns] * G[:, ns]) for ns in n_tiles])
    for kt, ks in enumerate(k_tiles):
        for nt, ns in enumerate(n_tiles):
            t = de[ks, ns]
            pdZs[nt, ks] = r(t) @ r(Xs[ns]) - t.sum(1)[:, None] * Zs[ks]
            pdXs[kt, ns] = r(t).T @ r(Zs[ks]) - t.sum(0)[:, None] * Xs[ns]
    slices, slice_len = fg.du_slices(N)
    pdU = torch.stack([r(dG[:, s * slice_len:(s + 1) * slice_len])
                       @ r(K[:, s * slice_len:(s + 1) * slice_len]).T
                       for s in range(slices)])

    def in_order(parts):
        out = torch.zeros_like(parts[0])
        for p in parts:
            out = out + p
        return out

    dU = in_order(pdU)
    return (torch.tril(dU) if lower else dU, in_order(pdZs),
            in_order(pdXs), in_order(pskv))


def _ragged(seed, M=200, N=5037, D=7, dtype=np.float64):
    """The ragged shape the gate admits, inputs scaled as on the card;
    ``Linv`` is NOT triangular, so ``lower`` has something to drop."""
    rng = np.random.default_rng(seed)
    ls = np.sqrt(D)
    Linv = rng.standard_normal((M, M)) * 0.05 + np.eye(M)
    return [torch.as_tensor(a.astype(dtype)) for a in (
        Linv, rng.uniform(0, 4, (M, D)) / ls, rng.uniform(0, 4, (N, D)) / ls,
        np.asarray(1.4), rng.standard_normal((M, N)) * 0.01)]


def test_tf32_rna_on_bit_patterns():
    """Ties go away from zero (where round-to-even would differ), a carry
    runs into the exponent, and inf and NaN pass through."""
    cases = {0x3F801000: 0x3F802000, 0xBF801000: 0xBF802000,
             0x3F800FFF: 0x3F800000, 0x3F801001: 0x3F802000,
             0x3F803000: 0x3F804000, 0x3F800000: 0x3F800000,
             0x3FFFF000: 0x40000000, 0x00001000: 0x00002000,
             0x80000FFF: 0x80000000, 0x7F800000: 0x7F800000,
             0xFF800000: 0xFF800000}
    src = np.array(list(cases), dtype=np.uint32).view(np.float32)
    got = _tf32_rna(torch.as_tensor(src)).numpy().view(np.uint32)
    assert [hex(v) for v in got] == [hex(v) for v in cases.values()]
    nan = _tf32_rna(torch.tensor([float("nan")], dtype=torch.float32))
    assert bool(torch.isnan(nan).all())


@pytest.mark.parametrize("lower", [False, True])
def test_k2_emulation_matches_float64_plain(lower):
    """K2's tiles, triangle skip and 3×TF32 product in float32 against
    the float64 plain version at the card's tolerances (rtol 2e-4, atol
    2e-5), and the same bits over two calls."""
    Linv, Zs, Xs, var, _ = _ragged(20)
    f32 = [t.float() for t in (Linv, Zs, Xs, var)]
    first = _emulate_fwd(*f32, lower)
    assert torch.equal(first, _emulate_fwd(*f32, lower))
    want = fg._fused_fwd_torch(Linv, Zs, Xs, var, lower)
    np.testing.assert_allclose(first.double().numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("lower", [False, True])
def test_k3_emulation_matches_float64_plain(lower):
    """K3's 1-pass TF32 products, partial slots and reduction order in
    float32 against the float64 plain version: within 2e-3 of each
    output's largest entry (the card's tolerance), the same bits over two
    calls."""
    Linv, Zs, Xs, var, dG = _ragged(21)
    f32 = [t.float() for t in (Linv, Zs, Xs, var, dG)]
    assert fg.du_slices(5037)[0] > 1
    G = _emulate_fwd(*f32[:4], lower)
    first = _emulate_bwd(*f32, G, lower)
    second = _emulate_bwd(*f32, G, lower)
    plain = fg._fused_bwd_torch(Linv, Zs, Xs, var, dG, lower)
    for a, b, p in zip(first, second, plain):
        assert torch.equal(a, b)
        assert float((a.double() - p).abs().max()) <= \
            2e-3 * float(p.abs().max())


@pytest.mark.parametrize("lower", [False, True])
def test_k3_reduction_order_emulation(lower):
    """The partial-buffer layout and second pass of K3, emulated in
    float64 without TF32 rounding on a ragged shape with several tiles
    and dU slices, equal the plain backward to 1e-12 and are bitwise
    stable across calls."""
    M, N, D = 150, 4500, 3
    assert fg.du_slices(N)[0] > 1
    Linv, Zs, Xs, var, dG = _ragged(4, M, N, D)
    G = fg._fused_fwd_torch(Linv, Zs, Xs, var, lower)
    first = _emulate_bwd(Linv, Zs, Xs, var, dG, G, lower, tf32=False)
    second = _emulate_bwd(Linv, Zs, Xs, var, dG, G, lower, tf32=False)
    plain = fg._fused_bwd_torch(Linv, Zs, Xs, var, dG, lower)
    for a, b, p in zip(first, second, plain):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_lower_is_the_function_of_tril():
    """float64: ``lower=True`` is the dense function of ``tril(Linv)``,
    forward and backward, through the autograd Function; its gradient in
    Linv is lower triangular, and ``lower=False`` keeps the upper
    triangle's contribution."""
    Linv, Zs, Xs, var, dG = _ragged(22, 70, 400, 5)
    args = [t.clone().requires_grad_(True) for t in (Linv, Zs, Xs, var)]
    G = fg.fused_linv_rbf_gram(*args, lower=True)
    G.backward(dG)
    refs = [t.clone().requires_grad_(True) for t in (Linv, Zs, Xs, var)]
    R = fg.reference_linv_rbf_gram(torch.tril(refs[0]), *refs[1:])
    R.backward(dG)
    np.testing.assert_allclose(G.detach().numpy(), R.detach().numpy(),
                               rtol=1e-12, atol=1e-12)
    for a, b in zip(args, refs):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-10, atol=1e-10)
    assert bool((torch.triu(args[0].grad, 1) == 0).all())
    dense = fg._fused_fwd_torch(Linv, Zs, Xs, var)
    assert float((dense - G.detach()).abs().max()) > 1e-3


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
    assert fg.du_slices(65536) == (64, 1024)
    assert fg.du_slices(100) == (1, 128)


@pytest.mark.parametrize("N", [1, 100, 1025, 4104, 4500, 5037, 65536,
                               100000, 262144, 10 ** 6])
def test_du_slices_start_on_aligned_columns(N):
    """K3b stages dG from column slice·slice_len on with 16-byte copies
    where a row is aligned; a slice length that is not a multiple of the
    ring's chunk (N = 4104 once gave 5 slices of 821) would misalign every
    slice after the first. Every slice is also non-empty."""
    slices, length = fg.du_slices(N)
    assert length % fg.DU_SLICE_ALIGN == 0 and fg.DU_SLICE_ALIGN % 4 == 0
    assert 1 <= slices <= fg.MAX_DU_SLICES
    assert slices * length >= N > (slices - 1) * length


def test_wrapper_rejects_other_devices():
    x = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fg.fused_linv_rbf_gram(torch.zeros((4, 4), device="meta"), x, x,
                               torch.ones((), device="meta"))
