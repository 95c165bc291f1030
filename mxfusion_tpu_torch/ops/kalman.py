"""Kalman filtering, RTS smoothing and LGSSM simulation.

Counterpart of ``mxfusion_tpu/ops/kalman.py``: the array workhorses
behind ``LinearGaussianSSM`` (``components/distributions/ssm.py``), a
linear-Gaussian state-space model

    x_t = A x_{t-1} + w_t,   w_t ~ N(0, Q)        (t = 1..T-1)
    y_t = H x_t + v_t,       v_t ~ N(0, R)        (t = 0..T-1)
    x_0 ~ N(m0, P0)

Every function takes an optional leading batch axis: ``y`` of shape
``(T, E)`` or ``(B, T, E)``, and parameters with the same leading axis
or none, so the distribution filters all of its samples in one loop over
time where JAX maps the filter over them.

The sequential filter and smoother are Python loops over time, about
30 small launches a step on the card. Nothing in a step waits for the
host: the Cholesky is ``ops.linalg.cholesky`` (``cholesky_ex``, no
error check, JAX's NaN pattern), the solves ``torch.cholesky_solve``,
and the first step is a Python branch. Every product of a step feeds a
Cholesky (through the Joseph form), so each is a HIGHEST-tier
:func:`~.precision.einsum`, IEEE fp32 forward and backward on the card;
the JAX package pins the ``p_einsum`` products and leaves the bare ``@``
ones (``A @ m``, ``K @ H``, ``K @ innov``) at the default precision,
which the port pins as well. The parallel-in-time filter and smoother
run their forward at IEEE fp32 throughout (TF32 off for the products,
the solves and the LU inside them), as JAX pins them at HIGHEST; their
backward runs at the caller's float32 matmul precision (IEEE unless
the caller has switched TF32 on).
"""
import torch

from . import precision
from ..common.config import as_torch_dtype
from .linalg import cholesky
from .precision import einsum as p_einsum
from .scan import associative_scan

_LOG2PI = 1.8378770664093453


def _mm(A, B):
    return p_einsum("...ij,...jk->...ik", A, B)


def _mmT(A, B):
    """A·Bᵀ."""
    return p_einsum("...ij,...kj->...ik", A, B)


def _mv(A, x):
    return p_einsum("...ij,...j->...i", A, x)


def _as(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _logdet_half(L):
    return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)


def kalman_filter(y, A, H, Q, R, m0, P0, mask=None):
    """Forward filter; returns a dict with

    - ``loglik``: log p(y_{0:T-1}), shape ``(B,)`` or ``()``
    - ``filtered_means`` (..., T, D), ``filtered_covs`` (..., T, D, D)
    - ``pred_means`` (..., T, D), ``pred_covs`` (..., T, D, D):
      p(x_t | y_{<t})
    - ``y_pred_means`` (..., T, E), ``y_pred_vars`` (..., T, E): the
      one-step-ahead observation predictive (diagonal)

    ``mask`` (..., T) marks observed steps (1) against missing ones (0):
    a missing step adds nothing to the likelihood and only predicts, and
    its y may be any finite placeholder."""
    y = torch.as_tensor(y)
    A, H, Q, R, m0, P0 = (_as(a, y) for a in (A, H, Q, R, m0, P0))
    T, E = y.shape[-2], y.shape[-1]
    eye_d = torch.eye(A.shape[-1], dtype=y.dtype, device=y.device)
    if mask is not None:
        mask = _as(mask, y)
        mask = mask.reshape(T) if y.ndim == 2 else \
            torch.broadcast_to(mask, y.shape[:-1])
    lead = tuple(y.shape[:-2])
    m = torch.broadcast_to(m0, lead + tuple(m0.shape[-1:]))
    P = torch.broadcast_to(P0, lead + tuple(P0.shape[-2:]))
    outs = {k: [] for k in ("filtered_means", "filtered_covs", "pred_means",
                            "pred_covs", "y_pred_means", "y_pred_vars")}
    lls = []
    for t in range(T):
        y_t = y[..., t, :]
        # no transition into t = 0: the prior N(m0, P0) is the predictive
        if t == 0:
            m_pred, P_pred = m, P
        else:
            m_pred = _mv(A, m)
            P_pred = _mmT(_mm(A, P), A) + Q
        S = _mmT(_mm(H, P_pred), H) + R
        L = cholesky(S)
        Hm = _mv(H, m_pred)
        innov = y_t - Hm
        if mask is not None:
            obs = mask[..., t]
            # the placeholder of a missing step goes before any arithmetic
            innov = torch.where(obs[..., None] > 0, innov,
                                torch.zeros_like(innov))
        alpha = torch.cholesky_solve(innov[..., None], L)[..., 0]
        K = torch.cholesky_solve(_mmT(P_pred, H).transpose(-1, -2), L) \
            .transpose(-1, -2)
        Kinnov = _mv(K, innov)
        IKH = eye_d - _mm(K, H)
        P_up = _mmT(_mm(IKH, P_pred), IKH) + _mmT(_mm(K, R), K)
        ll_t = -0.5 * (E * _LOG2PI + 2.0 * _logdet_half(L)
                       + torch.sum(innov * alpha, -1))
        if mask is None:
            m, P = m_pred + Kinnov, P_up
        else:
            m = m_pred + obs[..., None] * Kinnov
            o = obs[..., None, None]
            P = o * P_up + (1.0 - o) * P_pred
            ll_t = obs * ll_t
        lls.append(ll_t)
        for k, v in (("filtered_means", m), ("filtered_covs", P),
                     ("pred_means", m_pred), ("pred_covs", P_pred),
                     ("y_pred_means", Hm),
                     ("y_pred_vars", torch.diagonal(S, dim1=-2, dim2=-1))):
            outs[k].append(v)
    result = {"loglik": torch.sum(torch.stack(lls, -1), -1)}
    for k, v in outs.items():
        result[k] = torch.stack(v, dim=-3 if v[0].ndim == P.ndim else -2)
    return result


def rts_smoother(filtered_means, filtered_covs, pred_means, pred_covs, A):
    """Rauch-Tung-Striebel backward pass over the filter's outputs;
    returns (smoothed_means (..., T, D), smoothed_covs (..., T, D, D))."""
    ms = torch.as_tensor(filtered_means)
    Ps, mp, Pp, A = (_as(a, ms) for a in (filtered_covs, pred_means,
                                          pred_covs, A))
    m_s, P_s = ms[..., -1, :], Ps[..., -1, :, :]
    out_m, out_P = [m_s], [P_s]
    for t in range(ms.shape[-2] - 2, -1, -1):
        P = Ps[..., t, :, :]
        # G = P Aᵀ Pp_{t+1}⁻¹ by a Cholesky solve
        Lp = cholesky(Pp[..., t + 1, :, :])
        G = torch.cholesky_solve(_mmT(P, A).transpose(-1, -2), Lp) \
            .transpose(-1, -2)
        m_s = ms[..., t, :] + _mv(G, m_s - mp[..., t + 1, :])
        P_s = P + _mmT(_mm(G, P_s - Pp[..., t + 1, :, :]), G)
        out_m.append(m_s)
        out_P.append(P_s)
    return torch.stack(out_m[::-1], -2), torch.stack(out_P[::-1], -3)


def lgssm_path(z0, w, v, A, H, Q, R, m0, P0):
    """The trajectory that standard normals give: ``x0 = m0 + L0·z0``,
    ``x_t = A x_{t-1} + Lq·w_t``, ``y = H x + Lr·v`` with ``L·`` the
    Cholesky factors of P0, Q and R; ``z0`` (..., D), ``w`` (..., T-1, D)
    and ``v`` (..., T, E). Returns (x (..., T, D), y (..., T, E))."""
    Lq, Lr, L0 = cholesky(Q), cholesky(R), cholesky(P0)
    x = m0 + _mv(L0, z0)
    xs = [x]
    for t in range(w.shape[-2]):
        x = _mv(A, x) + _mv(Lq, w[..., t, :])
        xs.append(x)
    x = torch.stack(xs, -2)
    y = p_einsum("...ed,...td->...te", H, x) + \
        p_einsum("...ef,...tf->...te", Lr, v)
    return x, y


def lgssm_sample(generator, T, A, H, Q, R, m0, P0, dtype=None,
                 num_samples=None):
    """Simulate trajectories on ``generator``'s device; returns
    (x (T, D), y (T, E)), with a leading ``num_samples`` axis when one is
    given. The normals are drawn first (x0's, then w's, then v's) and
    :func:`lgssm_path` makes the trajectory from them."""
    dev = generator.device if generator is not None else None
    like = torch.as_tensor(A, device=dev)
    if dtype is not None:
        like = like.to(as_torch_dtype(dtype))
    A, H, Q, R, m0, P0 = (_as(a, like) for a in (A, H, Q, R, m0, P0))
    D, E = A.shape[-1], H.shape[-2]
    lead = () if num_samples is None else (num_samples,)

    def normal(*shape):
        return torch.randn(lead + shape, generator=generator,
                           dtype=like.dtype, device=like.device)

    z0, w, v = normal(D), normal(T - 1, D), normal(T, E)
    return lgssm_path(z0, w, v, A, H, Q, R, m0, P0)


# --------------------------------------------------------------------------
# parallel in time
# --------------------------------------------------------------------------

def _bmv(M, v):
    return (M @ v[..., None])[..., 0]


def _solve(A, B):
    """A⁻¹B without the host check of ``torch.linalg.solve`` (a singular
    A gives inf/NaN, as ``jnp.linalg.solve``)."""
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def kalman_filter_parallel(y, A, H, Q, R, m0, P0):
    """Parallel-in-time Kalman filter by an associative scan (Särkkä &
    García-Fernández 2021, "Temporal Parallelization of Bayesian
    Smoothers", IEEE TAC, filtering elements eq. 10-12): log depth over T
    instead of the sequential filter's T steps. Returns the same dict as
    :func:`kalman_filter` (no mask); the likelihood and the predictives
    come from the prefix results in one batched pass.

    Each element a_t = (A_t, b_t, C_t, eta_t, J_t) parameterizes
    p(x_t | y_t, x_{t-1}) = N(A_t x_{t-1} + b_t, C_t) and the information
    pair (eta, J) of the likelihood message; their composition is
    associative, so the all-prefix combine gives every filtering
    marginal at once."""
    y = torch.as_tensor(y)
    A, H, Q, R, m0, P0 = (_as(a, y) for a in (A, H, Q, R, m0, P0))
    # every product feeds covariance algebra that ends in a Cholesky:
    # IEEE fp32 inside, whatever the caller set (JAX's HIGHEST context)
    with precision._matmul_precision("highest"):
        return _kalman_filter_parallel(y, A, H, Q, R, m0, P0)


def _filter_combine(eye_d):
    def combine(a, b):
        A1, b1, C1, e1, J1 = a
        A2, b2, C2, e2, J2 = b
        # X (I + C1 J2)⁻¹ = solve((I + C1 J2)ᵀ, Xᵀ)ᵀ, batched over time
        IC = eye_d + C1 @ J2
        A2M = _solve(IC.transpose(-1, -2), A2.transpose(-1, -2)) \
            .transpose(-1, -2)                          # A2 (I + C1 J2)⁻¹
        N = eye_d + J2 @ C1
        A1tN = _solve(N.transpose(-1, -2), A1) \
            .transpose(-1, -2)                          # A1ᵀ (I + J2 C1)⁻¹
        An = A2M @ A1
        bn = _bmv(A2M, b1 + _bmv(C1, e2)) + b2
        Cn = A2M @ C1 @ A2.transpose(-1, -2) + C2
        en = _bmv(A1tN, e2 - _bmv(J2, b1)) + e1
        Jn = A1tN @ J2 @ A1 + J1
        return An, bn, Cn, en, Jn
    return combine


def _kalman_filter_parallel(y, A, H, Q, R, m0, P0):
    T, E = y.shape[-2], y.shape[-1]
    D = A.shape[-1]
    lead = tuple(y.shape[:-2])
    eye_d = torch.eye(D, dtype=y.dtype, device=y.device)
    Ht = H.transpose(-1, -2)
    # the generic element (t >= 1): the predictive covariance entering
    # it is Q (conditioning on x_{t-1} is exact)
    S = H @ Q @ Ht + R
    K = _solve(S, H @ Q).transpose(-1, -2)               # Q Hᵀ S⁻¹
    A_el = (eye_d - K @ H) @ A
    C_el = (eye_d - K @ H) @ Q
    HtSinv = _solve(S, H).transpose(-1, -2)              # Hᵀ S⁻¹
    b_el = y[..., 1:, :] @ K.transpose(-1, -2)           # (..., T-1, D)
    eta_el = y[..., 1:, :] @ (A.transpose(-1, -2) @ HtSinv).transpose(-1, -2)
    J_el = A.transpose(-1, -2) @ HtSinv @ H @ A
    # the first element absorbs the prior N(m0, P0) and y_0 (A_0 = 0)
    S0 = H @ P0 @ Ht + R
    K0 = _solve(S0, H @ P0).transpose(-1, -2)
    b0 = m0 + _bmv(K0, y[..., 0, :] - _bmv(H, m0))
    C0 = (eye_d - K0 @ H) @ P0

    def constant(M):
        """A (..., D, D) element repeated over t = 1..T-1."""
        return torch.broadcast_to(M.unsqueeze(-3), lead + (T - 1, D, D))

    def first(v, event):
        return torch.broadcast_to(v.unsqueeze(-len(event) - 1),
                                  lead + (1,) + event)

    def zeros(*event):
        return torch.zeros(lead + (1,) + event, dtype=y.dtype,
                           device=y.device)

    As = torch.cat([zeros(D, D), constant(A_el)], dim=-3)
    bs = torch.cat([first(b0, (D,)), b_el], dim=-2)
    Cs = torch.cat([first(C0, (D, D)), constant(C_el)], dim=-3)
    etas = torch.cat([zeros(D), eta_el], dim=-2)
    Js = torch.cat([zeros(D, D), constant(J_el)], dim=-3)
    _, ms, Ps, _, _ = associative_scan(
        _filter_combine(eye_d), (As, bs, Cs, etas, Js), axis=len(lead))

    # the predictives and the log-likelihood: one batched pass
    At = A.unsqueeze(-3)
    mp = torch.cat([torch.broadcast_to(m0.unsqueeze(-2), lead + (1, D)),
                    ms[..., :-1, :] @ A.transpose(-1, -2)], dim=-2)
    Pp = torch.cat([torch.broadcast_to(P0.unsqueeze(-3), lead + (1, D, D)),
                    At @ Ps[..., :-1, :, :] @ At.transpose(-1, -2)
                    + Q.unsqueeze(-3)], dim=-3)
    Sp = (H.unsqueeze(-3) @ Pp) @ Ht.unsqueeze(-3) + R.unsqueeze(-3)
    y_pred = mp @ Ht
    innov = y - y_pred
    Lp = cholesky(Sp)
    alpha = torch.cholesky_solve(innov[..., None], Lp)[..., 0]
    lls = -0.5 * (E * _LOG2PI + 2.0 * _logdet_half(Lp)
                  + torch.sum(innov * alpha, -1))
    return {"loglik": torch.sum(lls, -1), "filtered_means": ms,
            "filtered_covs": Ps, "pred_means": mp, "pred_covs": Pp,
            "y_pred_means": y_pred,
            "y_pred_vars": torch.diagonal(Sp, dim1=-2, dim2=-1)}


def rts_smoother_parallel(filtered_means, filtered_covs, pred_means,
                          pred_covs, A):
    """Parallel-in-time RTS smoother by a reversed associative scan
    (Särkkä & García-Fernández 2021, smoothing elements §IV): each
    element a_t = (E_t, g_t, L_t) parameterizes
    p(x_t | y_{0:t}, x_{t+1}) = N(E_t x_{t+1} + g_t, L_t), and the
    reversed all-prefix combine gives every smoothing marginal at log
    depth. Returns what :func:`rts_smoother` returns."""
    ms = torch.as_tensor(filtered_means)
    Ps, mp, Pp, A = (_as(a, ms) for a in (filtered_covs, pred_means,
                                          pred_covs, A))
    lead = tuple(ms.shape[:-2])
    D = ms.shape[-1]
    with precision._matmul_precision("highest"):
        # the smoother gains G_t = P_t Aᵀ Pp_{t+1}⁻¹ for t < T-1
        Lp = cholesky(Pp[..., 1:, :, :])
        PAt = Ps[..., :-1, :, :] @ A.unsqueeze(-3).transpose(-1, -2)
        G = torch.cholesky_solve(PAt.transpose(-1, -2), Lp).transpose(-1, -2)
        g = ms[..., :-1, :] - _bmv(G, mp[..., 1:, :])
        # G Pp Gᵀ = (P Aᵀ) Gᵀ exactly, since G = P Aᵀ Pp⁻¹
        L = Ps[..., :-1, :, :] - PAt @ G.transpose(-1, -2)
        # the terminal element is the filtered marginal itself (E = 0)
        E_all = torch.cat([G, torch.zeros(lead + (1, D, D), dtype=ms.dtype,
                                          device=ms.device)], dim=-3)
        g_all = torch.cat([g, ms[..., -1:, :]], dim=-2)
        L_all = torch.cat([L, Ps[..., -1:, :, :]], dim=-3)

        def combine(a, b):
            # reversed, the scan passes the later-time accumulator as `a`
            # and the earlier element as `b`: the composition is
            # earlier ∘ later
            E2, g2, L2 = a
            E1, g1, L1 = b
            return (E1 @ E2, _bmv(E1, g2) + g1,
                    E1 @ L2 @ E1.transpose(-1, -2) + L1)

        _, m_s, P_s = associative_scan(combine, (E_all, g_all, L_all),
                                       reverse=True, axis=len(lead))
    return m_s, P_s
