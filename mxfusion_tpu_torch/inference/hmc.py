"""Hamiltonian Monte Carlo over a FactorGraph's latent variables.

Counterpart of ``mxfusion_tpu/inference/hmc.py``, which also holds the
scaffolding that the other samplers (ChEES-HMC, SGLD, SVGD, parallel
tempering) share. Chains ride the leading sample axis, so one
transition is one batched potential-and-gradient over all C chains: the
per-chain joint log-density is the sum of ``FactorGraph.log_pdf_terms``.

PyTorch runs eagerly, so the chain is a Python loop over transitions
where JAX ``lax.scan``s one program. Each transition is a private
function that takes its random draws as arguments, and every tensor a
chain carries is detached after each transition, so autograd never
holds more than one potential evaluation. The potential and its
gradient come from one forward and one ``torch.autograd.grad`` over the
chain tensors alone (:func:`value_and_grad`); the value and gradient at
the current state carry across transitions, so a transition of L
leapfrog steps evaluates the potential L times (JAX evaluates it L + 3
times: L + 1 gradients and the two Hamiltonians).

Constrained latents (positive / unit-interval / simplex support,
declared by the generating distribution's ``support``) are sampled in
an unconstrained space through log / logit / stick-breaking bijectors
with the Jacobian folded into the potential (:class:`SupportTransforms`),
the NumPyro convention. Samples are returned in the native support.
"""
import numpy as np
import torch

from .inference import Inference
from .inference_alg import (SamplingAlgorithm, VariableEnv,
                            create_sampling_executor)
from ..common.exceptions import InferenceError
from ..ops import simplex as simplex_ops
from ..ops.elementwise import softplus

# dual averaging (Hoffman & Gelman 2014, §3.2)
_DA_GAMMA, _DA_T0, _DA_KAPPA = 0.05, 10.0, 0.75


def _per_chain_sum(x):
    """Sum every axis except the leading chain axis."""
    return torch.sum(x.reshape((x.shape[0], -1)), dim=-1)


def _rows(mask, like):
    """A (C,) mask shaped to broadcast over ``like``'s event axes."""
    return mask.reshape((mask.shape[0],) + (1,) * (like.ndim - 1))


# --- shared sampler scaffolding (HMC / ChEES / SGLD / SVGD / PT) -------

def sampler_latent_uuids(algorithm, name):
    """The latent RANDVAR uuids a sampler targets; raises if none."""
    latents = [v.uuid for v in algorithm.model.get_latent_variables(
        algorithm.observed_variable_UUIDs)]
    if not latents:
        raise InferenceError("{}: the model has no latent variables "
                             "given the observed set.".format(name))
    return latents


def detached_env(env):
    """A ``VariableEnv`` copy of ``env`` with every tensor detached: a
    chain takes gradients in its own tensors alone, and the trainable
    parameters the env carries collect none."""
    return VariableEnv({k: v.detach() if isinstance(v, torch.Tensor) else v
                        for k, v in env.items()})


def init_chains_from_prior(model, env, generator, latent_uuids,
                           num_chains):
    """Ancestral prior draws, broadcast to C entries on the sample
    axis: the standard chain/particle initialization."""
    with torch.no_grad():
        drawn = model.draw_samples(VariableEnv(env), generator,
                                   num_samples=num_chains)
    q = {}
    for u in latent_uuids:
        a = drawn[u].detach()
        if a.shape[0] != num_chains:
            a = a.expand((num_chains,) + tuple(a.shape[1:])).clone()
        q[u] = a
    return q


class SupportTransforms:
    """Bijectors taking constrained latents to an unconstrained sampling
    space (NumPyro-style): positive -> log/exp, unit_interval ->
    logit/sigmoid, simplex -> stick-breaking over the LAST event axis
    (K -> K-1 unconstrained coordinates; ``ops/simplex.py``).
    ``log_jacobian`` is the per-chain sum of log|dx/dz| to fold into the
    potential so the chain targets the correct density in z-space."""

    def __init__(self, supports):
        self.supports = supports

    def unconstrain(self, q):
        # boundary guard: a prior draw that underflows to exactly 0 (or
        # rounds to 1) would map to an infinite z0 and stick the chain
        # (accept_prob 0 forever); clip by the dtype's eps
        out = {}
        for u, x in q.items():
            s = self.supports.get(u, "real")
            if s == "positive":
                out[u] = torch.log(torch.clamp(
                    x, min=torch.finfo(x.dtype).tiny))
            elif s == "unit_interval":
                eps = torch.finfo(x.dtype).eps
                x = torch.clamp(x, eps, 1.0 - eps)
                out[u] = torch.log(x) - torch.log1p(-x)
            elif s == "simplex":
                out[u] = simplex_ops.inverse(x)
            else:
                out[u] = x
        return out

    def constrain(self, z):
        out = {}
        for u, zv in z.items():
            s = self.supports.get(u, "real")
            if s == "positive":
                out[u] = torch.exp(zv)
            elif s == "unit_interval":
                out[u] = torch.sigmoid(zv)
            elif s == "simplex":
                out[u] = simplex_ops.forward(zv)
            else:
                out[u] = zv
        return out

    def log_jacobian(self, z):
        tot = None
        for u, zv in z.items():
            s = self.supports.get(u, "real")
            if s == "positive":
                term = _per_chain_sum(zv)
            elif s == "unit_interval":
                term = _per_chain_sum(-softplus(zv) - softplus(-zv))
            elif s == "simplex":
                term = _per_chain_sum(
                    simplex_ops.log_det_jacobian(zv)[..., None])
            else:
                continue
            tot = term if tot is None else tot + term
        return tot


def make_support_transforms(model, latent_uuids):
    """SupportTransforms for the latents whose generating factor
    declares a non-real ``support``; None when every latent is real
    (no extra ops in the potential)."""
    supports = {}
    for u in latent_uuids:
        f = model.variables[u].factor
        supports[u] = getattr(f, "support", "real")
    if all(s == "real" for s in supports.values()):
        return None
    return SupportTransforms(supports)


def sum_log_pdf_terms(terms, dtype):
    """Per-chain total of log_pdf_terms: size-1 sample-axis terms
    broadcast; everything cast to the latent dtype (observed-data
    terms may be wider, e.g. float64 data against float32 chains)."""
    tot = torch.zeros((), dtype=dtype,
                      device=terms[0].device if terms else None)
    for t in terms:
        t = t.to(dtype)
        tot = tot + (t if t.shape[0] != 1 else t[0])
    return tot


def log_posterior(model, env, ctx, bij, dtype):
    """``log_post(q) -> (C,)``: the per-chain log joint at chain states
    ``q`` (sampling space), the Jacobian of the support bijectors
    included. Each call evaluates the model on a fresh ``VariableEnv``
    copy of ``env``."""
    def log_post(q):
        e = VariableEnv(env)
        e.update(bij.constrain(q) if bij is not None else q)
        lp = sum_log_pdf_terms(model.log_pdf_terms(e, ctx=ctx), dtype)
        if bij is not None:
            lp = lp + bij.log_jacobian(q).to(dtype)
        return lp
    return log_post


def value_and_grad(fn, q, reduce=None):
    """``fn(q)`` and the gradient of its sum in the chain tensors ``q``,
    both detached: one forward and one backward, with gradients taken
    in ``q`` alone (nothing else accumulates a ``.grad``). ``reduce``
    (a ``RuntimeContext``'s ``data_reduction``, over data split on a
    mesh) turns one rank's value and gradient into the whole data's."""
    with torch.enable_grad():
        leaves = {u: v.detach().requires_grad_(True) for u, v in q.items()}
        out = fn(leaves)
        grads = torch.autograd.grad(torch.sum(out), list(leaves.values()),
                                    allow_unused=True)
    out = out.detach()
    grads = {u: torch.zeros_like(leaves[u]) if gr is None else gr
             for u, gr in zip(leaves, grads)}
    if reduce is not None:
        out, grads = reduce(out, grads)
    return out, grads


def _kinetic(p, inv_mass):
    k = None
    for u, v in p.items():
        term = 0.5 * _per_chain_sum(
            v ** 2 if inv_mass is None else v ** 2 * inv_mass[u])
        k = term if k is None else k + term
    return k


def _leapfrog(q, p, g, eps, inv_mass, n_steps, potential):
    """``n_steps`` leapfrog steps from (q, p), ``g`` the potential's
    gradient at q. ``eps`` is a step (a scalar tensor) or {uuid: step}
    (per-replica steps); ``inv_mass`` {uuid: diagonal} or None for the
    identity. ``potential(q) -> (U, grad U)`` runs once per step, the
    last at the endpoint. Returns (q1, p1, U1, g1); U1 is None when
    ``n_steps`` is 0."""
    step = eps if isinstance(eps, dict) else {u: eps for u in q}
    p = {u: p[u] - 0.5 * step[u] * g[u] for u in p}
    U = None
    for i in range(n_steps):
        q = {u: q[u] + step[u] * (p[u] if inv_mass is None
                                  else inv_mass[u] * p[u]) for u in q}
        U, g = potential(q)
        # full momentum step except after the last position step
        scale = 0.5 if i == n_steps - 1 else 1.0
        p = {u: p[u] - scale * step[u] * g[u] for u in p}
    return q, p, U, g


def _hmc_transition(q, U, g, p0, log_u, eps, inv_mass, n_steps,
                    potential):
    """One Metropolis-corrected HMC proposal for all chains, on explicit
    draws: momentum ``p0`` and ``log_u`` (C,). ``U`` and ``g`` are the
    potential and its gradient at ``q``. Returns the new state with its
    (U, g), the per-chain acceptance probability (a NaN trajectory
    counts as a rejection: its dH is NaN, so ``log_u < dH`` is False),
    the (C,) accept mask and the proposal (q1, p1)."""
    H0 = U + _kinetic(p0, inv_mass)
    q1, p1, U1, g1 = _leapfrog(q, p0, g, eps, inv_mass, n_steps,
                               potential)
    if U1 is None:
        U1 = U
    H1 = U1 + _kinetic(p1, inv_mass)
    dH = H0 - H1
    accept = log_u < dH
    qn = {u: torch.where(_rows(accept, q[u]), q1[u], q[u]) for u in q}
    gn = {u: torch.where(_rows(accept, g[u]), g1[u], g[u]) for u in g}
    Un = torch.where(accept, U1, U)
    accept_prob = torch.clamp(torch.exp(dH), max=1.0)
    # guard NaN trajectories (divergences count as rejections)
    accept_prob = torch.where(torch.isnan(accept_prob),
                              torch.zeros_like(accept_prob), accept_prob)
    return qn, Un, gn, accept_prob, accept, (q1, p1)


def _dual_averaging(state, accept_stat, target_accept, mu):
    """One dual-averaging update of the log step size. ``state`` is
    (log_eps, log_eps_bar, h_bar, t), scalar tensors of the latent
    dtype."""
    log_eps, log_eps_bar, h_bar, t = state
    t = t + 1.0
    h_bar = (1.0 - 1.0 / (t + _DA_T0)) * h_bar + \
        (target_accept - accept_stat) / (t + _DA_T0)
    log_eps = mu - torch.sqrt(t) / _DA_GAMMA * h_bar
    w = t ** (-_DA_KAPPA)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return log_eps, log_eps_bar, h_bar, t


def _dual_averaging_start(eps):
    zero = torch.zeros((), dtype=eps.dtype, device=eps.device)
    return torch.log(eps), torch.log(eps), zero, zero


def _normal_draws(q, generator):
    """One standard-normal draw shaped like each chain tensor."""
    return {u: torch.randn(v.shape, generator=generator, dtype=v.dtype,
                           device=v.device) for u, v in q.items()}


def _log_uniform(n, generator, dtype, device):
    return torch.log(torch.rand((n,), generator=generator, dtype=dtype,
                                device=device))


def _stack(draws):
    """A list of {uuid: (C, ...)} -> {uuid: (S, C, ...)}."""
    return {u: torch.stack([d[u] for d in draws]) for u in draws[0]}


def effective_sample_size(samples, max_lag=None):
    """ESS via the initial-monotone-sequence estimator (Geyer 1992)
    over autocorrelations averaged across chains; samples (S, C, ...),
    a numpy array or a tensor on any device."""
    x = samples.detach().cpu().numpy() if isinstance(samples, torch.Tensor) \
        else np.asarray(samples)
    shape = x.shape[2:]
    S, C = x.shape[:2]
    x = x.reshape(S, C, -1)
    x = x - x.mean(axis=0, keepdims=True)
    max_lag = min(S - 1, max_lag or S - 1)
    var0 = (x ** 2).mean(axis=(0, 1))          # (D,)
    var0 = np.where(var0 == 0, 1.0, var0)
    rho = np.empty((max_lag + 1,) + var0.shape)
    rho[0] = 1.0
    for t in range(1, max_lag + 1):
        rho[t] = (x[:-t] * x[t:]).mean(axis=(0, 1)) / var0
    # sum paired autocorrelations while the pair sums stay positive
    ess = np.empty_like(var0)
    for d in range(var0.shape[0]):
        s = 0.0
        for t in range(1, max_lag, 2):
            pair = rho[t, d] + rho[t + 1, d]
            if pair <= 0:
                break
            s += pair
        ess[d] = S * C / (1.0 + 2.0 * s)
    return ess.reshape(shape) if shape else float(ess[0])


def potential_scale_reduction(samples):
    """Split R-hat (Gelman et al.) for samples shaped (S, C, ...)."""
    x = torch.as_tensor(samples)
    S = x.shape[0]
    half = S // 2
    x = torch.cat([x[:half], x[half:2 * half]], dim=1)
    n = x.shape[0]
    chain_mean = torch.mean(x, dim=0)
    chain_var = torch.var(x, dim=0, correction=1)
    W = torch.mean(chain_var, dim=0)
    B = n * torch.var(chain_mean, dim=0, correction=1)
    var_est = (n - 1) / n * W + B / n
    return torch.sqrt(var_est / W)


def _as_numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


class HMCAlgorithm(SamplingAlgorithm):
    """HMC posterior sampling of the model's latent RANDVARs.

    Parameters
    ----------
    num_samples : int
        Post-warmup draws kept per chain.
    num_warmup : int
        Adaptation draws (dual averaging of the step size toward
        ``target_accept``; discarded).
    num_chains : int
        Chains, vectorized on the sample axis (prior-initialized).
    num_leapfrog : int
    step_size : float
        Initial leapfrog step size (adapted during warmup).
    target_accept : float

    ``compute`` returns ``(samples, diagnostics)``: samples is
    {uuid: (num_samples, num_chains, *event_shape)} over the latent
    (or requested target) variables; diagnostics holds the per-chain
    acceptance rate and the adapted step size.
    """

    def __init__(self, model, observed, num_samples=500, num_warmup=500,
                 num_chains=4, step_size=0.1, num_leapfrog=16,
                 target_accept=0.8, adapt_mass=True,
                 target_variables=None, extra_graphs=None):
        super().__init__(model=model, observed=observed,
                         num_samples=num_samples,
                         target_variables=target_variables,
                         extra_graphs=extra_graphs)
        self.num_warmup = num_warmup
        self.num_chains = num_chains
        self.step_size = step_size
        self.num_leapfrog = num_leapfrog
        self.target_accept = target_accept
        # diagonal metric adaptation (Stan-style): the first half of
        # warmup estimates per-dimension posterior variance (chains
        # pooled), the second half re-adapts the step size under it
        self.adapt_mass = adapt_mass

    #: every potential goes through value_and_grad, so data split on a
    #: mesh is reduced there (``parallel.data_parallel``)
    reduces_over_data = True

    def _latent_uuids(self):
        return sampler_latent_uuids(self, "HMC")

    def compute(self, env, ctx):
        C = self.num_chains
        latent_uuids = self._latent_uuids()
        env = detached_env(env)
        generator = ctx.next_generator()
        # chains initialized by ancestral prior draws (C on sample axis)
        q = init_chains_from_prior(self.model, env, generator,
                                   latent_uuids, C)
        dtype = q[latent_uuids[0]].dtype
        device = q[latent_uuids[0]].device
        bij = make_support_transforms(self.model, latent_uuids)
        if bij is not None:
            q = bij.unconstrain(q)
        log_post = log_posterior(self.model, env, ctx, bij, dtype)

        def potential(q):
            return value_and_grad(lambda x: -log_post(x), q,
                                  ctx.data_reduction)

        def step(q, U, g, eps, inv_mass):
            p0 = {u: v / torch.sqrt(inv_mass[u]) for u, v in
                  _normal_draws(q, generator).items()}
            log_u = _log_uniform(C, generator, dtype, device)
            return _hmc_transition(q, U, g, p0, log_u, eps, inv_mass,
                                   self.num_leapfrog, potential)[:4]

        def run_warmup(q, U, g, eps_init, inv_mass, n, accumulate):
            mu = torch.log(10.0 * eps_init)
            state = _dual_averaging_start(eps_init)
            s1 = {u: torch.zeros(q[u].shape[1:], dtype=dtype, device=device)
                  for u in q}
            s2 = {u: torch.zeros_like(v) for u, v in s1.items()}
            for _ in range(n):
                q, U, g, accept_prob = step(q, U, g, torch.exp(state[0]),
                                            inv_mass)
                # observed-data log-pdf terms may be wider (float64) than
                # the latent dtype; adaptation keeps the latent dtype
                state = _dual_averaging(state,
                                        torch.mean(accept_prob).to(dtype),
                                        self.target_accept, mu)
                if accumulate:
                    s1 = {u: s1[u] + torch.sum(q[u], dim=0) for u in s1}
                    s2 = {u: s2[u] + torch.sum(q[u] ** 2, dim=0)
                          for u in s2}
            return q, U, g, torch.exp(state[1]), s1, s2

        with torch.no_grad():
            U, g = potential(q)
            eps = torch.as_tensor(self.step_size, dtype=dtype, device=device)
            inv_mass = {u: torch.ones(q[u].shape[1:], dtype=dtype,
                                      device=device) for u in q}
            if self.adapt_mass and self.num_warmup >= 4:
                n1 = self.num_warmup // 2
                q, U, g, eps, s1, s2 = run_warmup(q, U, g, eps, inv_mass,
                                                  n1, True)
                n_obs = n1 * C
                # inverse metric = posterior variance (Stan)
                inv_mass = {u: torch.clamp(
                    s2[u] / n_obs - (s1[u] / n_obs) ** 2, 1e-6, 1e6)
                    for u in s1}
                q, U, g, eps, _, _ = run_warmup(
                    q, U, g, eps, inv_mass, self.num_warmup - n1, False)
            else:
                q, U, g, eps, _, _ = run_warmup(q, U, g, eps, inv_mass,
                                                self.num_warmup, False)
            draws, accept_probs = [], []
            for _ in range(self.num_samples):
                q, U, g, accept_prob = step(q, U, g, eps, inv_mass)
                draws.append(q)
                accept_probs.append(accept_prob)
            chain = _stack(draws)
            if bij is not None:
                chain = bij.constrain(chain)  # back to the native support
        targets = self.target_variables if self.target_variables \
            else latent_uuids
        samples = {u: chain[u] for u in targets}
        diagnostics = {
            "accept_rate": torch.mean(torch.stack(accept_probs), dim=0),
            "step_size": eps,
        }
        return samples, diagnostics


def _chain_convergence_diagnostics(samples):
    """Split R-hat per latent plus the worst value across all latents
    and dimensions: the at-a-glance convergence summary every
    multi-chain inference attaches to its diagnostics."""
    r_hat = {u: _as_numpy(potential_scale_reduction(a))
             for u, a in samples.items() if a.shape[0] >= 4}
    out = {"r_hat": r_hat}
    if r_hat:
        out["r_hat_max"] = float(max(np.max(v) for v in r_hat.values()))
    return out


class HMCInference(Inference):
    """The inference: ``run(**data)`` returns the posterior sample dict and
    stores ``.diagnostics`` (accept_rate per chain, adapted step size,
    split R-hat per latent and its max across latents).

    Example::

        infr = HMCInference(HMCAlgorithm(model=m, observed=[m.y],
                                         num_samples=500, num_chains=4))
        samples = infr.run(y=y)[q_uuid]      # (500, 4, *event)
        infr.diagnostics["accept_rate"], infr.diagnostics["r_hat_max"]
    """

    def run(self, generator=None, **kwargs):
        samples, diagnostics = super().run(generator=generator, **kwargs)
        self.diagnostics = {k: _as_numpy(v) for k, v in diagnostics.items()}
        self.diagnostics.update(_chain_convergence_diagnostics(samples))
        self._samples = samples
        return samples

    def sample_predictive(self, generator=None, samples=None, targets=None,
                          **data):
        """Posterior-predictive draws: ancestral sampling of the model
        with the latents pinned to the stored (or given) draws, one
        draw of every downstream variable per posterior sample. Chains
        merge onto the standard leading sample axis.

        Returns {uuid: (num_samples * num_chains, *event_shape)} for
        ``targets`` (default: the model's leaves not given as data).
        """
        if samples is None:
            samples = getattr(self, "_samples", None)
        if samples is None:
            raise InferenceError("run() the chain before "
                                 "sample_predictive().")
        if generator is None:
            generator = torch.Generator(
                device=self.params.device).manual_seed(0)
        alg = self._algorithm
        flat = {}
        for u, a in samples.items():
            a = torch.as_tensor(a, device=self.params.device)
            flat[u] = a.reshape((-1,) + tuple(a.shape[2:]))
        n = next(iter(flat.values())).shape[0]

        class _Predictive(SamplingAlgorithm):
            def compute(self, env, ctx):
                env = VariableEnv(env)
                env.update(flat)   # pinned latents: sampling skips them
                with torch.no_grad():
                    return self.model.draw_samples(
                        env, ctx.next_generator(), num_samples=n,
                        targets=self.target_variables)

        # only the variables actually passed stay observed; the rest
        # (e.g. the training targets) are ancestrally sampled
        observed = [v for v in alg.observed_variables if v.name in data]
        pred_alg = _Predictive(
            model=alg.model, observed=observed, num_samples=n,
            target_variables=[t.uuid if hasattr(t, "uuid") else t
                              for t in targets] if targets else None)
        executor = create_sampling_executor(pred_alg, self.params)
        data_list = [data[v.name] for v in observed]
        return executor(self.params.trainable_params(),
                        self.params.fixed_params(), data_list, generator)
