"""``ops.kalman`` and ``ops.scan`` against the JAX package.

The same float64 inputs, made from a numpy seed at the JAX tests' shapes
(D = 2, E = 1, T = 80 from ``tests/components/distributions/
test_ssm.py``, and D = 3, E = 2, T = 64 from its parallel-filter test),
go through both packages' filters and smoothers: every output agrees at
rtol 1e-10, the parallel ones with JAX's parallel ones at 1e-10 and with
its sequential ones at the JAX tests' own tolerances, the log-likelihood
gradients at 1e-9. ``associative_scan`` reproduces
``jax.lax.associative_scan`` on a combine that does not commute,
forward and reversed. JAX's parallel functions are compiled once, at the
small shape, in a module fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxfusion_tpu.ops import kalman as jk

from mxfusion_tpu_torch.ops import kalman as tk
from mxfusion_tpu_torch.ops.scan import associative_scan
from tests.test_torch_meanfield import _on_the_cpu_in_float64  # noqa: F401

RTOL = 1e-10
KEYS = ("loglik", "filtered_means", "filtered_covs", "pred_means",
        "pred_covs", "y_pred_means", "y_pred_vars")


def lgssm_small(seed=0):
    """test_ssm.py's system (D = 2, E = 1) and a T = 80 series from it."""
    A = np.array([[0.9, 0.2], [0.0, 0.7]])
    H = np.array([[1.0, 0.5]])
    Q, R = np.eye(2) * 0.05, np.eye(1) * 0.1
    m0, P0 = np.zeros(2), np.eye(2)
    rng = np.random.default_rng(seed)
    x = np.zeros((80, 2))
    x[0] = rng.multivariate_normal(m0, P0)
    for t in range(1, 80):
        x[t] = A @ x[t - 1] + rng.multivariate_normal(np.zeros(2), Q)
    y = x @ H.T + rng.multivariate_normal(np.zeros(1), R, size=80)
    return y, A, H, Q, R, m0, P0


def lgssm_wide(seed=7):
    """test_parallel_filter_matches_sequential's system (D = 3, E = 2,
    T = 64)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((3, 3)) * 0.3 + np.eye(3) * 0.5
    H = rng.standard_normal((2, 3))
    Q = np.eye(3) * 0.05 + np.ones((3, 3)) * 0.01
    R = np.eye(2) * 0.1
    m0 = rng.standard_normal(3)
    P0 = np.eye(3) * 0.7
    y = rng.standard_normal((64, 2))
    return y, A, H, Q, R, m0, P0


SYSTEMS = {"D2_E1_T80": lgssm_small, "D3_E2_T64": lgssm_wide}


def mask_for(T, seed=9):
    return (np.random.default_rng(seed).random(T) < 0.7).astype(np.float64)


def to_t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def close(a, b, rtol=RTOL, atol=0.0, err_msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def smooth(smoother, out, A):
    return smoother(out["filtered_means"], out["filtered_covs"],
                    out["pred_means"], out["pred_covs"], A)


@pytest.fixture(scope="module")
def jax_parallel():
    """JAX's parallel filter (every output, and the log-likelihood's
    gradient in A, Q and R) and parallel smoother on the wide system,
    each compiled once."""
    y, A, H, Q, R, m0, P0 = lgssm_wide()

    def loglik(A_, Q_, R_):
        out = jk.kalman_filter_parallel(y, A_, H, Q_, R_, m0, P0)
        return out["loglik"], out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loglik, argnums=(0, 1, 2), has_aux=True))(A, Q, R)
    seq = jk.kalman_filter(y, A, H, Q, R, m0, P0)
    smoothed = jax.jit(jk.rts_smoother_parallel)(
        seq["filtered_means"], seq["filtered_covs"], seq["pred_means"],
        seq["pred_covs"], A)
    return out, grads, smoothed


# ---------------------------------------------------------------------
# the sequential filter and smoother
# ---------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_filter_matches_jax(system, masked):
    args = SYSTEMS[system]()
    mask = mask_for(args[0].shape[0]) if masked else None
    ref = jk.kalman_filter(*args, mask=mask)
    out = tk.kalman_filter(*to_t(*args), mask=None if mask is None
                           else torch.as_tensor(mask))
    assert sorted(out) == sorted(KEYS)
    for k in KEYS:
        assert tuple(out[k].shape) == tuple(np.shape(ref[k])), k
        close(out[k], ref[k], err_msg=k)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_rts_smoother_matches_jax(system):
    args = SYSTEMS[system]()
    A = args[1]
    ref = smooth(jk.rts_smoother, jk.kalman_filter(*args), A)
    out = smooth(tk.rts_smoother, tk.kalman_filter(*to_t(*args)),
                 torch.as_tensor(A))
    close(out[0], ref[0])
    close(out[1], ref[1])


def test_masked_filter_ignores_placeholders():
    """test_masked_filter_matches_numpy_and_ignores_placeholders: a
    placeholder of 1e12 at the masked steps leaves the log-likelihood as
    it was, to 1e-14."""
    y, *rest = lgssm_small(9)
    mask = mask_for(80)
    clean = tk.kalman_filter(*to_t(y, *rest), mask=torch.as_tensor(mask))
    y_poison = np.where(mask[:, None] > 0, y, 1e12)
    poisoned = tk.kalman_filter(*to_t(y_poison, *rest),
                                mask=torch.as_tensor(mask))
    close(poisoned["loglik"], clean["loglik"].numpy(), rtol=1e-14)
    close(clean["loglik"], jk.kalman_filter(y, *rest, mask=mask)["loglik"])


def test_batched_filter_matches_each_series():
    """A leading batch axis filters each series as the JAX filter does
    alone: three series, each with its own A and mask."""
    y, A, H, Q, R, m0, P0 = lgssm_wide()
    ys = np.stack([y, 0.5 * y, y + 1.0])
    As = np.stack([A, 0.9 * A, A.T])
    masks = np.stack([mask_for(64, s) for s in (1, 2, 3)])
    for mask in (None, masks):
        out = tk.kalman_filter(*to_t(ys, As, H, Q, R, m0, P0),
                               mask=None if mask is None
                               else torch.as_tensor(mask))
        par = tk.kalman_filter_parallel(*to_t(ys, As, H, Q, R, m0, P0)) \
            if mask is None else None
        for i in range(3):
            ref = jk.kalman_filter(ys[i], As[i], H, Q, R, m0, P0,
                                   mask=None if mask is None else mask[i])
            for k in KEYS:
                close(out[k][i], ref[k], err_msg=k)
                if par is not None:
                    close(par[k][i], ref[k], rtol=1e-8, atol=1e-10,
                          err_msg=k)


# ---------------------------------------------------------------------
# the associative scan and the parallel filter and smoother
# ---------------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reverse"])
@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_associative_scan_matches_jax(n, reverse):
    """Products of 2×2 matrices (a combine that does not commute), and a
    second element carried beside them (sums), at 1e-12."""
    rng = np.random.default_rng(n)
    mats = np.eye(2) + 0.3 * rng.standard_normal((n, 2, 2))
    vecs = rng.standard_normal((n, 3))
    ref = jax.jit(lambda e: jax.lax.associative_scan(
        lambda a, b: (a[0] @ b[0], a[1] + b[1]), e,
        reverse=reverse))((mats, vecs))
    out = associative_scan(lambda a, b: (a[0] @ b[0], a[1] + b[1]),
                           to_t(mats, vecs), reverse=reverse)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        close(o, r, rtol=1e-12)


def test_associative_scan_along_a_batch_axis():
    """With a leading batch axis the scan runs along axis 1 and gives
    each row's own scan."""
    rng = np.random.default_rng(3)
    mats = np.eye(2) + 0.3 * rng.standard_normal((3, 9, 2, 2))
    out, = associative_scan(lambda a, b: (a[0] @ b[0],), to_t(mats),
                            reverse=True, axis=1)
    for i in range(3):
        ref, = jax.lax.associative_scan(lambda a, b: (a[0] @ b[0],),
                                        (mats[i],), reverse=True)
        close(out[i], ref, rtol=1e-12)


def test_parallel_filter_matches_jax(jax_parallel):
    args = lgssm_wide()
    ref_par, _, _ = jax_parallel
    ref_seq = jk.kalman_filter(*args)
    out = tk.kalman_filter_parallel(*to_t(*args))
    for k in KEYS:
        close(out[k], ref_par[k], err_msg=k)
        close(out[k], ref_seq[k], rtol=1e-8, atol=1e-10, err_msg=k)


def test_parallel_filter_matches_sequential_small():
    """test_parallel_filter_through_distribution's system: the parallel
    log-likelihood equals JAX's sequential one at 1e-9, every output at
    1e-8."""
    args = lgssm_small(8)
    ref = jk.kalman_filter(*args)
    out = tk.kalman_filter_parallel(*to_t(*args))
    close(out["loglik"], ref["loglik"], rtol=1e-9)
    for k in KEYS:
        close(out[k], ref[k], rtol=1e-8, atol=1e-10, err_msg=k)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_parallel_smoother_matches_jax(system, jax_parallel):
    args = SYSTEMS[system](12) if system == "D2_E1_T80" else lgssm_wide()
    A = args[1]
    seq = jk.kalman_filter(*args)
    ref_seq = smooth(jk.rts_smoother, seq, A)
    out = smooth(tk.rts_smoother_parallel, tk.kalman_filter(*to_t(*args)),
                 torch.as_tensor(A))
    close(out[0], ref_seq[0], rtol=1e-8, atol=1e-10)
    close(out[1], ref_seq[1], rtol=1e-7, atol=1e-10)
    if system == "D3_E2_T64":
        _, _, ref_par = jax_parallel
        close(out[0], ref_par[0])
        close(out[1], ref_par[1])


# ---------------------------------------------------------------------
# gradients and simulation
# ---------------------------------------------------------------------

@pytest.mark.parametrize("parallel", [False, True], ids=["sequential",
                                                         "parallel"])
def test_loglik_gradient_matches_jax(parallel, jax_parallel):
    y, A, H, Q, R, m0, P0 = lgssm_wide()
    if parallel:
        _, ref, _ = jax_parallel
    else:
        ref = jax.grad(lambda A_, Q_, R_: jk.kalman_filter(
            y, A_, H, Q_, R_, m0, P0)["loglik"], argnums=(0, 1, 2))(A, Q, R)
    At, Qt, Rt = (torch.tensor(a, requires_grad=True) for a in (A, Q, R))
    filt = tk.kalman_filter_parallel if parallel else tk.kalman_filter
    ll = filt(*to_t(y), At, *to_t(H), Qt, Rt, *to_t(m0, P0))["loglik"]
    grads = torch.autograd.grad(ll, (At, Qt, Rt))
    for g, r in zip(grads, ref):
        close(g, r, rtol=1e-9)


def test_lgssm_path_on_jax_normals():
    """``lgssm_sample``'s deterministic part on the normals JAX's
    ``lgssm_sample`` draws from its split keys."""
    _, A, H, Q, R, m0, P0 = lgssm_wide()
    T, key = 64, jax.random.PRNGKey(3)
    kx0, kw, kv = jax.random.split(key, 3)
    z0 = jax.random.normal(kx0, (3,), dtype=jnp.float64)
    w = jax.random.normal(kw, (T - 1, 3), dtype=jnp.float64)
    v = jax.random.normal(kv, (T, 2), dtype=jnp.float64)
    x_ref, y_ref = jk.lgssm_sample(key, T, jnp.asarray(A), H, Q, R, m0, P0)
    x, y = tk.lgssm_path(*to_t(np.asarray(z0), np.asarray(w), np.asarray(v),
                               A, H, Q, R, m0, P0))
    close(x, x_ref, rtol=1e-12)
    close(y, y_ref, rtol=1e-12)


def test_lgssm_sample_draws_on_the_generator():
    """Shapes, the batch axis, and the same draws from the same seed."""
    _, A, H, Q, R, m0, P0 = lgssm_small()

    def draw(seed, **kw):
        return tk.lgssm_sample(torch.Generator().manual_seed(seed), 50,
                               *to_t(A, H, Q, R, m0, P0), **kw)

    x, y = draw(0)
    assert tuple(x.shape) == (50, 2) and tuple(y.shape) == (50, 1)
    xb, yb = draw(0, num_samples=4)
    assert tuple(xb.shape) == (4, 50, 2) and tuple(yb.shape) == (4, 50, 1)
    assert torch.equal(draw(0)[1], y) and not torch.equal(draw(1)[1], y)


def test_products_are_pinned_at_ieee(monkeypatch):
    """Every product of the sequential filter and smoother, forward and
    backward, bare ``@`` ones of the JAX filter included, is a
    HIGHEST-tier einsum: with the caller's float32 matmul precision at
    "medium" each runs at "highest" and no plain matmul runs. The parallel
    filter's forward runs wholly at "highest" (its products are plain
    matmuls inside the pin)."""
    seen = []
    einsum = torch.einsum

    def spying_einsum(*args):
        seen.append(torch.get_float32_matmul_precision())
        return einsum(*args)

    def refuse(*args, **kwargs):
        raise AssertionError("a product outside the precision tiers")

    args = [t.float() for t in to_t(*lgssm_wide())]
    for a in (args[1], args[3], args[4]):
        a.requires_grad_(True)
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        with monkeypatch.context() as mp:
            mp.setattr(torch, "einsum", spying_einsum)
            mp.setattr(torch, "matmul", refuse)
            mp.setattr(torch.Tensor, "__matmul__", refuse)
            out = tk.kalman_filter(*args, mask=torch.ones(64))
            out["loglik"].backward()
            smooth(tk.rts_smoother, out, args[1])
        assert seen and set(seen) == {"highest"}
        solves = []
        solve_ex = torch.linalg.solve_ex

        def spying_solve(*a, **kw):
            solves.append(torch.get_float32_matmul_precision())
            return solve_ex(*a, **kw)

        monkeypatch.setattr(torch.linalg, "solve_ex", spying_solve)
        tk.kalman_filter_parallel(*args)
        assert solves and set(solves) == {"highest"}
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(old)
