"""The port's precision tiers and linalg helpers against the JAX package.

The tiers are autograd Functions whose forward and backward each pin
their own matmul precision; on the CPU every tier computes in plain
float32/float64, so their values are held to the JAX package's in
float64, and which tier each direction asked for is read by recording
the pins."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mxfusion_tpu.ops import linalg as jlinalg
from mxfusion_tpu.ops import precision as jprecision
from mxfusion_tpu_torch.ops import linalg, precision

EQS = [("...ij,...jk->...ik", (2, 3, 4), (2, 4, 5)),
       ("...mn,...md->...nd", (1, 6, 7), (1, 6, 2)),
       ("...ik,...jk->...ij", (3, 4), (2, 5, 4)),        # broadcast batch
       ("md,nd->mn", (6, 3), (5, 3))]
FUNCS = ["einsum", "data_einsum", "guarded_data_einsum"]


class _RecordMatmulPrecision(TorchDispatchMode):
    """Records ``torch.get_float32_matmul_precision()`` at every aten
    mm/bmm call."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm):
            self.seen.append(torch.get_float32_matmul_precision())
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _global_precision(name):
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(name)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def test_highest_einsum_backward_products_stay_highest():
    """The fault of the first port: its HIGHEST einsum switched TF32 off
    for the forward only, and autograd ran the backward products later
    at the user's setting. With the global precision at "medium", every
    matmul of the backward must run at "highest"."""
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.standard_normal((2, 8, 5)), dtype=torch.float32)
    B = torch.as_tensor(rng.standard_normal((2, 5, 6)), dtype=torch.float32)
    A.requires_grad_(True)
    B.requires_grad_(True)
    with _global_precision("medium"):
        C = precision.einsum("...ij,...jk->...ik", A, B)
        rec = _RecordMatmulPrecision()
        with rec:
            C.sum().backward()
        assert torch.get_float32_matmul_precision() == "medium"
    assert len(rec.seen) >= 2, rec.seen
    assert set(rec.seen) == {"highest"}, rec.seen


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("eq,sa,sb", EQS)
def test_tier_values_and_gradients_match_jax(func, eq, sa, sb):
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal(sa), rng.standard_normal(sb)
    jfn = getattr(jprecision, func)
    out_j, vjp = jax.vjp(lambda x, y: jfn(eq, x, y), jnp.asarray(a),
                         jnp.asarray(b))
    g = rng.standard_normal(out_j.shape)
    ga_j, gb_j = vjp(jnp.asarray(g))
    A, B = (torch.as_tensor(x).requires_grad_(True) for x in (a, b))
    out = getattr(precision, func)(eq, A, B)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(A.grad.numpy(), np.asarray(ga_j),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(B.grad.numpy(), np.asarray(gb_j),
                               rtol=1e-12, atol=1e-12)


def test_guarded_forward_matmul_gradients_and_jvp_match_jax():
    """Reverse mode, and forward mode through ``torch.func.jvp`` (which
    Laplace needs), against the JAX custom_jvp."""
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((1, 4, 6)), rng.standard_normal((1, 6, 9))
    ta, tb = rng.standard_normal(a.shape), rng.standard_normal(b.shape)
    out_j, tan_j = jax.jvp(jprecision.guarded_forward_matmul,
                           (jnp.asarray(a), jnp.asarray(b)),
                           (jnp.asarray(ta), jnp.asarray(tb)))
    out, tan = torch.func.jvp(precision.guarded_forward_matmul,
                              tuple(map(torch.as_tensor, (a, b))),
                              tuple(map(torch.as_tensor, (ta, tb))))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-12)
    np.testing.assert_allclose(tan.numpy(), np.asarray(tan_j), rtol=1e-12)
    ga_j, gb_j = jax.grad(
        lambda x, y: jnp.sum(jnp.sin(jprecision.guarded_forward_matmul(
            x, y))), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    A, B = (torch.as_tensor(x).requires_grad_(True) for x in (a, b))
    torch.sum(torch.sin(precision.guarded_forward_matmul(A, B))).backward()
    np.testing.assert_allclose(A.grad.numpy(), np.asarray(ga_j), rtol=1e-12)
    np.testing.assert_allclose(B.grad.numpy(), np.asarray(gb_j), rtol=1e-12)


@pytest.mark.parametrize("tier,fwd,bwd", [
    ("default", "high", "default"), ("high", "high", "high"),
    ("highest", "highest", "highest")])
def test_each_direction_asks_for_its_tier(monkeypatch, tier, fwd, bwd):
    """guarded_forward_matmul: forward at the HIGH floor, cotangents at
    the configured tier, the tier being the one set when the forward
    ran (``precision.py:107-152`` of the JAX package)."""
    asked = []
    real = precision._pinned
    monkeypatch.setattr(precision, "_pinned",
                        lambda t, x: asked.append(t) or real(t, x))
    A = torch.ones((3, 4), requires_grad=True)
    B = torch.ones((4, 2), requires_grad=True)
    with precision.data_precision_scope(tier):
        out = precision.guarded_forward_matmul(A, B)
    assert asked == [fwd]
    out.sum().backward()
    assert asked == [fwd, bwd]
    asked.clear()
    with precision.data_precision_scope(tier):
        precision.data_einsum("ij,jk->ik", A, B)
        precision.guarded_data_einsum("ij,jk->ik", A, B)
        precision.einsum("ij,jk->ik", A, B)
    assert asked == [tier, fwd, "highest"]


def test_data_precision_setting_and_scope():
    assert precision.get_data_precision() == "default"
    with precision.data_precision_scope("HIGHEST"):
        assert precision.get_data_precision() == "highest"
    assert precision.get_data_precision() == "default"
    precision.set_data_precision("high")
    try:
        assert precision.get_data_precision() == "high"
    finally:
        precision.set_data_precision("default")
    with pytest.raises(ValueError, match="data precision"):
        precision.set_data_precision("medium")
    with pytest.raises(ValueError, match="two operands"):
        precision.einsum("ij->ji", torch.ones(2, 2), torch.ones(2, 2))


def test_tier_map_on_the_card():
    """HIGHEST and the HIGH floor -> IEEE fp32, the relaxed data tier ->
    TF32 (ROADMAP's north star)."""
    assert precision._CUDA_MATMUL == {"highest": "highest",
                                      "high": "highest", "default": "high"}


# ---------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------

def _spd_chol(rng, s, M):
    A = rng.standard_normal((s, M, M))
    return np.linalg.cholesky(A @ np.swapaxes(A, -1, -2) + M * np.eye(M))


@pytest.mark.parametrize("n_rhs", [7, 40])   # narrow and wide (>= 4M)
def test_wide_triangular_solve_matches_jax(n_rhs):
    rng = np.random.default_rng(3)
    L = _spd_chol(rng, 2, 8)
    B = rng.standard_normal((2, 8, n_rhs))
    want = np.asarray(jlinalg.wide_triangular_solve(jnp.asarray(L),
                                                    jnp.asarray(B)))
    got = linalg.wide_triangular_solve(torch.as_tensor(L),
                                       torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_triangular_inverse_and_cholesky_logdet_match_jax():
    rng = np.random.default_rng(4)
    L = _spd_chol(rng, 3, 6)
    np.testing.assert_allclose(
        linalg.triangular_inverse(torch.as_tensor(L)).numpy(),
        np.asarray(jlinalg.triangular_inverse(jnp.asarray(L))),
        rtol=1e-12, atol=1e-12)
    A = L @ np.swapaxes(L, -1, -2)
    Lt, ld = linalg.cholesky_logdet(torch.as_tensor(A))
    Lj, ldj = jlinalg.cholesky_logdet(jnp.asarray(A))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), rtol=1e-12)
