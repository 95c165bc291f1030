"""Model comparison from posterior samples: WAIC and PSIS-LOO.

Counterpart of ``mxfusion_tpu/inference/model_comparison.py``. Standard
definitions (Vehtari, Gelman & Gabry 2017): both start from the
pointwise log-likelihood matrix ``loglik[s, n] = log p(y_n | θ_s)`` over
S posterior draws, computed here in ONE batched density evaluation with
the draws on the framework's sample axis.

``waic``: elpd ≈ Σ_n [logmeanexp_s loglik - Var_s loglik].
``loo_psis``: leave-one-out elpd via Pareto-smoothed importance
sampling (raw weights 1/p(y_n|θ_s); the largest 20% replaced by
generalized-Pareto quantiles, Zhang & Stephens 2009 fit), with the
per-point Pareto-k diagnostic.

The JAX package runs both in numpy with a Python loop over data points.
Here they are torch functions in float64 on the log-likelihood's
device, vectorized across points: one sort along S, the tail of M draws
of every column, and the Zhang-Stephens fit batched over columns in
chunks that bound its (columns, m_est, M) intermediate. The smoothed
weights stay in sorted order, which changes no sum but its order.
"""
import contextlib
import math

import numpy as np
import torch

from .inference_alg import (SamplingAlgorithm, VariableEnv,
                            create_sampling_executor)
from ..common.exceptions import InferenceError
from ..util.inference import discover_shape_constants

# elements of the Zhang-Stephens fit's (columns, m_est, M) intermediate
# per chunk: 2^24 float64 values, 128 MB
_FIT_CHUNK_ELEMENTS = 1 << 24


def pointwise_log_likelihood(infr, samples=None, generator=None,
                             has_chain_axis=True, **data):
    """Per-datapoint log-likelihoods under stored posterior draws.

    Parameters
    ----------
    infr : HMCInference / SGLDInference / any Inference whose
        ``_samples`` hold {uuid: (S, C, *event)} draws (or pass
        ``samples`` explicitly).
    has_chain_axis : bool
        False for particle draws shaped (S, *event) with no chain
        axis (SVGDInference).
    data : the observed data arrays by variable name (as in ``run``).

    Returns {observed_name: (S*C, N)} tensors on the run's device —
    (S, N) when ``has_chain_axis=False`` — the likelihood factor's
    log-density summed over trailing event dims, the leading data axis
    kept, for every observed variable given in ``data`` that has a
    generating factor (conditioning inputs such as a design matrix have
    none and give no entry).
    """
    from ..modules.module import Module
    alg = infr._algorithm
    if samples is None:
        samples = getattr(infr, "_samples", None)
    if samples is None:
        raise InferenceError("run() the sampler first (or pass "
                             "samples=...).")
    params = infr.params
    event_from = 2 if has_chain_axis else 1
    flat = {}
    for u, a in samples.items():
        a = torch.as_tensor(a, device=params.device)
        flat[u] = a.reshape((-1,) + tuple(a.shape[event_from:]))
    S = next(iter(flat.values())).shape[0]
    model = alg.model
    observed = [v for v in alg.observed_variables if v.name in data]
    if not observed:
        raise InferenceError(
            "pass the observed data arrays by name, e.g. y=y.")

    class _Pointwise(SamplingAlgorithm):
        def compute(self, env, ctx):
            env = VariableEnv(env)
            env.update(flat)
            # deterministic factors upstream must evaluate first;
            # targets=[] skips every density term (pure env fill)
            model.log_pdf_terms(env, targets=[], ctx=ctx)
            out = {}
            for v in observed:
                f = v.factor
                if f is None:
                    # a conditioning input (a design matrix X): no
                    # density of its own (the JAX package raises
                    # AttributeError here)
                    continue
                if isinstance(f, Module):
                    raise InferenceError(
                        "pointwise_log_likelihood needs an explicit "
                        "likelihood factor; Module-valued observations "
                        "({}) marginalize internally.".format(v.name))
                lp = f.log_pdf(env)            # (S, N, *event)
                out[v.name] = torch.sum(
                    lp.reshape(tuple(lp.shape[:2]) + (-1,)), dim=-1)
            return out

    pw = _Pointwise(model=model, observed=observed, num_samples=S)
    if generator is None:
        generator = torch.Generator(device=params.device).manual_seed(0)
    data_list = [data[v.name] for v in observed]
    with _shapes_bound_to(params, model, {
            v.uuid: np.shape(d) for v, d in zip(observed, data_list)}):
        executor = create_sampling_executor(pw, params)
        with torch.no_grad():
            return executor(params.trainable_params(),
                            params.fixed_params(), data_list, generator)


@contextlib.contextmanager
def _shapes_bound_to(params, model, data_shapes):
    """Symbolic data dims bound to ``data_shapes`` ({uuid: shape}) for
    the block. A minibatch sampler (SGLD) leaves them bound to the BATCH
    size; an evaluation over the full data re-binds them, and the run's
    bindings come back after."""
    rebound = discover_shape_constants(
        {u: tuple(shape) for u, shape in data_shapes.items()}, [model])
    saved = {u: params.constants.get(u) for u in rebound}
    params.constants.update(rebound)
    try:
        yield
    finally:
        for u, v in saved.items():
            if v is None:
                params.constants.pop(u, None)
            else:
                params.constants[u] = v


def _as_float64(a):
    """``a`` (a tensor on any device, or an array) as a float64 tensor,
    on its device."""
    return torch.as_tensor(a).to(torch.float64)


def _logmeanexp(a, dim=0):
    m = torch.amax(a, dim=dim)
    return m + torch.log(torch.mean(torch.exp(a - m.unsqueeze(dim)),
                                    dim=dim))


def _logsumexp(a, dim=0):
    # the JAX package's max-shifted sum (torch.logsumexp treats an
    # all -inf column differently)
    m = torch.amax(a, dim=dim)
    return m + torch.log(torch.sum(torch.exp(a - m.unsqueeze(dim)),
                                   dim=dim))


def waic(loglik):
    """Widely applicable information criterion.

    ``loglik``: (S, N), a tensor (computed on its device) or an array.
    Returns dict with ``elpd_waic``, ``p_waic``, ``se`` (standard error
    over data points) as floats and ``pointwise``, a float64 tensor.
    """
    loglik = _as_float64(loglik)
    lppd_i = _logmeanexp(loglik, dim=0)
    p_i = torch.var(loglik, dim=0, correction=1)
    elpd_i = lppd_i - p_i
    n = loglik.shape[1]
    return {"elpd_waic": float(elpd_i.sum()),
            "p_waic": float(p_i.sum()),
            "se": float(torch.sqrt(n * torch.var(elpd_i, correction=1))),
            "pointwise": elpd_i}


def _gpd_fit(x):
    """Generalized-Pareto (xi, sigma) fit to exceedances x > 0, each row
    of ``x`` (..., n) one sample — the Zhang & Stephens (2009)
    posterior-mean estimator in the STANDARD xi convention (xi > 0 =
    heavy tail), with the weak Vehtari-et-al. prior pulling xi toward
    0.5 at tiny n. Returns float64 tensors (xi, sigma) shaped x's
    leading dims."""
    x = torch.sort(_as_float64(x), dim=-1).values
    n = x.shape[-1]
    if n < 5:
        return (torch.full(x.shape[:-1], 0.5, dtype=x.dtype,
                           device=x.device),
                torch.clamp(torch.mean(x, dim=-1), min=1e-12))
    prior_bs, prior_k = 3.0, 10.0
    m_est = 30 + int(np.sqrt(n))
    j = torch.arange(1, m_est + 1, dtype=x.dtype, device=x.device)
    b = 1.0 - torch.sqrt(m_est / (j - 0.5))                  # (m_est,)
    b = b / (prior_bs * x[..., int(n / 4 + 0.5) - 1, None]) + \
        1.0 / x[..., -1, None]                                # (..., m_est)
    # theta-profile log-likelihood; k here = -xi (the Z&S internal k)
    k = torch.mean(torch.log1p(-b[..., :, None] * x[..., None, :]),
                   dim=-1)
    l_b = n * (torch.log(-b / k) - k - 1.0)
    w = torch.exp(l_b - torch.amax(l_b, dim=-1, keepdim=True))
    w = w / torch.sum(w, dim=-1, keepdim=True)
    b_post = torch.sum(b * w, dim=-1)
    k_post = torch.mean(torch.log1p(-b_post[..., None] * x), dim=-1)
    sigma = -k_post / b_post
    # k_post = mean(log1p(-b x)) = -k_ZS = +xi; regularize toward 0.5
    # (weakly informative prior) and report the standard xi
    xi = (n * k_post + prior_k * 0.5) / (n + prior_k)
    return xi, sigma


def _gpd_quantiles(p, xi, sigma):
    """Inverse CDF of GPD(xi, sigma): sigma/xi ((1-p)^-xi - 1), for
    probabilities ``p`` (M,) and parameters (...): returns (..., M)."""
    p = _as_float64(p).to(device=torch.as_tensor(xi).device)
    xi = _as_float64(xi)[..., None]
    sigma = _as_float64(sigma)[..., None]
    log1m_p = torch.log1p(-p)
    return torch.where(torch.abs(xi) < 1e-12, -sigma * log1m_p,
                       sigma * torch.expm1(-xi * log1m_p) / xi)


def loo_psis(loglik):
    """PSIS-LOO: Pareto-smoothed importance-sampling leave-one-out.

    ``loglik``: (S, N), a tensor (computed on its device in float64) or
    an array. Returns dict with ``elpd_loo``, ``p_loo``, ``se`` as floats
    and ``pareto_k`` (per-point diagnostic; k > 0.7 flags unreliable
    points) and ``pointwise``, float64 tensors.
    """
    loglik = _as_float64(loglik)
    S, N = loglik.shape
    logw = -loglik                       # raw IS log-weights
    logw = logw - torch.amax(logw, dim=0)
    raw_max = torch.amax(logw, dim=0)    # PSIS truncation level
    lw, order = torch.sort(logw, dim=0)  # ascending along S
    ll = torch.gather(loglik, 0, order)  # the same permutation
    M = int(min(0.2 * S, 3 * np.sqrt(S)))
    if M >= 5:
        tail = lw[-M:]                                    # (M, N)
        cutoff = torch.exp(lw[-M - 1])                    # (N,)
        exceed = (torch.exp(tail) - cutoff).T             # (N, M)
        m_est = 30 + int(np.sqrt(M))
        chunk = max(1, _FIT_CHUNK_ELEMENTS // (m_est * M))
        fits = [_gpd_fit(exceed[i:i + chunk]) for i in range(0, N, chunk)]
        ks = torch.cat([f[0] for f in fits])
        sigma = torch.cat([f[1] for f in fits])
        finite = torch.isfinite(ks)
        # replace the tail by GPD quantiles (smoothing), then truncate
        # at the raw maximum; a column whose fit is not finite keeps its
        # raw weights
        p = (torch.arange(1, M + 1, dtype=lw.dtype, device=lw.device)
             - 0.5) / M
        smoothed = cutoff[:, None] + _gpd_quantiles(p, ks, sigma)
        tail_s = torch.log(torch.clamp(smoothed, min=1e-300)).T  # (M, N)
        smoothed_lw = torch.minimum(torch.cat([lw[:-M], tail_s]), raw_max)
        lw = torch.where(finite, smoothed_lw, lw)
    else:
        # too few draws for a tail fit: plain (truncated) IS,
        # diagnostic unavailable
        ks = torch.full((N,), math.nan, dtype=lw.dtype, device=lw.device)
    lw = lw - _logsumexp(lw, dim=0)      # normalized log-weights
    elpd_i = _logsumexp(lw + ll, dim=0)
    lppd_i = _logmeanexp(loglik, dim=0)
    return {"elpd_loo": float(elpd_i.sum()),
            "p_loo": float((lppd_i - elpd_i).sum()),
            "se": float(torch.sqrt(N * torch.var(elpd_i, correction=1))),
            "pareto_k": ks,
            "pointwise": elpd_i}


def posterior_predictive_check(infr, statistic, observed_name,
                               generator=None, **data):
    """Bayesian posterior predictive check (Gelman et al., BDA ch. 6).

    Replicates the observed variable from the stored posterior draws
    (one y_rep per draw via ``sample_predictive``), evaluates a test
    statistic on each replicate and on the real data, and returns the
    posterior predictive p-value  P(T(y_rep) >= T(y_obs)).

    Parameters
    ----------
    infr : a sampler Inference (HMC/ChEES/SGLD/SVGD) that has run.
    statistic : callable(tensor) -> float or 0-d tensor, evaluated on
        one replicate's event tensor on the run's device and on the
        real data as a tensor of the run's dtype there (e.g.
        ``lambda y: y.var(correction=0)``).
    observed_name : name of the checked variable; its real data must be
        in ``data`` and is EXCLUDED from conditioning.
    data : observed arrays by name (conditioning inputs + the checked
        variable's realization).

    Returns dict with ``p_value``, ``T_obs`` (floats) and ``T_rep``
    (per-draw statistics, a float64 tensor). Extreme p-values (< 0.05 or
    > 0.95) flag aspects of the data the model cannot reproduce.
    """
    if observed_name not in data:
        raise InferenceError(
            "pass the checked variable's data, e.g. {}=y."
            .format(observed_name))
    params = infr.params
    model = infr._algorithm.model
    y_obs = torch.as_tensor(data[observed_name], dtype=params.dtype,
                            device=params.device)
    cond = {k: v for k, v in data.items() if k != observed_name}
    target = getattr(model, observed_name)
    # replicates of the data's size, also after a minibatch sampler
    with _shapes_bound_to(params, model, {
            getattr(model, k).uuid: np.shape(v) for k, v in data.items()}):
        (y_rep,) = infr.sample_predictive(generator=generator,
                                          targets=[target.uuid], **cond)
    T_rep = torch.tensor([float(statistic(y_rep[s]))
                          for s in range(y_rep.shape[0])],
                         dtype=torch.float64)
    T_obs = float(statistic(y_obs))
    return {"p_value": float(torch.mean((T_rep >= T_obs).double())),
            "T_obs": T_obs, "T_rep": T_rep}
