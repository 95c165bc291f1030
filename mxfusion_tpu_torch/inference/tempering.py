"""Parallel-tempering (replica-exchange) HMC.

Counterpart of ``mxfusion_tpu/inference/tempering.py``. K replicas of
every chain sample the tempered targets ``pi_beta ∝ exp(beta · log p)``
on a geometric inverse-temperature ladder (beta_0 = 1 cold ...
beta_{K-1} hot); after every HMC sweep, even/odd adjacent-pair state
swaps are proposed and accepted with the Metropolis ratio
``exp((beta_i − beta_j)(logp(x_j) − logp(x_i)))`` (Swendsen & Wang 1986;
Earl & Deem 2005). Hot replicas roam across modes and ferry states down
to beta = 1.

All C·K replicas ride the leading sample axis: one batched gradient per
leapfrog step whatever K is, and the swap pass is a permutation and
``torch.where``. Per-replica step sizes follow ``eps · beta^(-1/2)``.
The untempered log posterior and its gradient carry across sweeps and
through the swaps, so a sweep of L leapfrog steps evaluates the model
L times. Support bijectors apply as in plain HMC (the tempered
potential is ``beta · (logp + log|J|)``).
"""
import numpy as np
import torch

from .inference import Inference
from .inference_alg import SamplingAlgorithm
from .hmc import (HMCInference, _chain_convergence_diagnostics,
                  _dual_averaging, _dual_averaging_start, _hmc_transition,
                  _log_uniform, _normal_draws, _rows, _stack, _as_numpy,
                  detached_env, init_chains_from_prior, log_posterior,
                  make_support_transforms, sampler_latent_uuids,
                  value_and_grad)


def _swap_pass(q, lp, glp, betas, t_idx, num_temps, parity, log_u):
    """Even/odd adjacent-pair swaps within each chain block, on explicit
    draws ``log_u`` (R,). Pair (t, t+1) with t ≡ parity (mod 2): the
    LOWER row of a pair proposes to swap with its +1 neighbour. ``lp``
    (the untempered log posterior at q; the power posterior's
    log-likelihood) and the {name: tensor} ``glp`` (its gradient; the
    power posterior's prior terms) move with the states. Returns (q, lp,
    glp, do_swap, is_lower)."""
    lp_up = torch.roll(lp, -1)
    beta_up = torch.roll(betas, -1)
    is_lower = (t_idx % 2 == parity) & (t_idx < num_temps - 1)
    log_alpha = (betas - beta_up) * (lp_up - lp)
    do_swap = is_lower & (log_u < log_alpha)          # (R,)
    take_next = do_swap                               # row r <- r+1
    take_prev = torch.roll(do_swap, 1)                # row r <- r-1

    def permute(x):
        sel_n, sel_p = _rows(take_next, x), _rows(take_prev, x)
        return torch.where(sel_n, torch.roll(x, -1, dims=0),
                           torch.where(sel_p, torch.roll(x, 1, dims=0), x))

    return ({u: permute(v) for u, v in q.items()}, permute(lp),
            {u: permute(v) for u, v in glp.items()}, do_swap, is_lower)


class ParallelTemperingAlgorithm(SamplingAlgorithm):
    """Replica-exchange HMC over the model's latent RANDVARs.

    Parameters
    ----------
    num_samples, num_warmup : int
        Kept cold-chain draws / discarded adaptation sweeps.
    num_chains : int
        Independent chains per temperature.
    num_temps : int
        Ladder size K (1 degenerates to plain HMC).
    max_inv_temp_ratio : float
        beta_{K-1} (the hottest inverse temperature); the ladder is
        geometric between 1 and this value.
    step_size, num_leapfrog, target_accept : HMC controls (the step
        size is dual-averaged during warmup on the pooled accept rate).

    ``compute`` returns ``(samples, diagnostics)``: samples is
    {uuid: (num_samples, num_chains, *event_shape)} from the COLD
    replicas only; diagnostics add the per-adjacent-pair swap
    acceptance rate (the ladder-health signal: near zero for some pair
    means the ladder has a gap there).
    """

    def __init__(self, model, observed, num_samples=500, num_warmup=500,
                 num_chains=4, num_temps=6, max_inv_temp_ratio=0.05,
                 step_size=0.1, num_leapfrog=16, target_accept=0.8,
                 target_variables=None, extra_graphs=None):
        super().__init__(model=model, observed=observed,
                         num_samples=num_samples,
                         target_variables=target_variables,
                         extra_graphs=extra_graphs)
        if num_temps < 1:
            raise ValueError("num_temps must be >= 1.")
        self.num_warmup = num_warmup
        self.num_chains = num_chains
        self.num_temps = num_temps
        self.max_inv_temp_ratio = max_inv_temp_ratio
        self.step_size = step_size
        self.num_leapfrog = num_leapfrog
        self.target_accept = target_accept

    #: every potential goes through value_and_grad (see HMCAlgorithm)
    reduces_over_data = True

    def _latent_uuids(self):
        return sampler_latent_uuids(self, "PT-HMC")

    def compute(self, env, ctx):
        C, K = self.num_chains, self.num_temps
        R = C * K                      # replicas on the sample axis
        latent_uuids = self._latent_uuids()
        env = detached_env(env)
        generator = ctx.next_generator()
        q = init_chains_from_prior(self.model, env, generator,
                                   latent_uuids, R)
        dtype = q[latent_uuids[0]].dtype
        device = q[latent_uuids[0]].device
        bij = make_support_transforms(self.model, latent_uuids)
        if bij is not None:
            q = bij.unconstrain(q)
        # geometric beta ladder, tiled per chain: row r = chain r//K,
        # temperature r%K (so adjacent temperatures are adjacent rows)
        betas_k = torch.as_tensor(
            np.geomspace(1.0, self.max_inv_temp_ratio, K), dtype=dtype,
            device=device)
        betas = betas_k.repeat(C)                          # (R,)
        t_idx = torch.arange(K, device=device).repeat(C)   # (R,)
        # hotter replicas take wider steps
        eps_scale = betas ** -0.5
        log_post = log_posterior(self.model, env, ctx, bij, dtype)

        def tempered(lp, glp):         # (U, grad U) = -beta·(lp, glp)
            return -betas * lp, {u: -_rows(betas, v) * v
                                 for u, v in glp.items()}

        def sweep(q, lp, glp, eps, parity):
            """One tempered HMC proposal for all replicas, then a swap
            pass. ``lp``/``glp`` are the untempered log posterior of q
            and its gradient, carried so that the model runs once per
            leapfrog step."""
            p0 = _normal_draws(q, generator)
            log_u = _log_uniform(R, generator, dtype, device)
            end = {}

            def potential(x):
                end["lp"], end["glp"] = value_and_grad(
                    log_post, x, ctx.data_reduction)
                return tempered(end["lp"], end["glp"])

            U, g = tempered(lp, glp)
            step = {u: _rows(eps * eps_scale, q[u]) for u in q}
            qn, _, _, accept_prob, accept, _ = _hmc_transition(
                q, U, g, p0, log_u, step, None, self.num_leapfrog,
                potential)
            if end:
                lp = torch.where(accept, end["lp"], lp)
                glp = {u: torch.where(_rows(accept, v), end["glp"][u], v)
                       for u, v in glp.items()}
            swap_u = _log_uniform(R, generator, dtype, device)
            return _swap_pass(qn, lp, glp, betas, t_idx, K, parity,
                              swap_u) + (accept_prob,)

        with torch.no_grad():
            lp, glp = value_and_grad(log_post, q, ctx.data_reduction)
            # ---- warmup: dual averaging of the base step size on the
            # pooled accept statistic
            eps0 = torch.as_tensor(self.step_size, dtype=dtype,
                                   device=device)
            mu = torch.log(10.0 * eps0)
            state = _dual_averaging_start(eps0)
            for i in range(self.num_warmup):
                q, lp, glp, _, _, accept_prob = sweep(
                    q, lp, glp, torch.exp(state[0]), i % 2)
                state = _dual_averaging(state,
                                        torch.mean(accept_prob).to(dtype),
                                        self.target_accept, mu)
            eps = torch.exp(state[1])
            # ---- sampling
            draws, accept_probs, swaps, proposing = [], [], [], []
            for i in range(self.num_samples):
                q, lp, glp, do_swap, is_lower, accept_prob = sweep(
                    q, lp, glp, eps, i % 2)
                draws.append(q)
                accept_probs.append(accept_prob)
                swaps.append(do_swap)
                proposing.append(is_lower)
            chain = _stack(draws)
            if bij is not None:
                chain = bij.constrain(chain)
        # keep only the cold replicas: rows with t_idx == 0,
        # (S, R, ...) -> (S, C, ...)
        cold = torch.nonzero(t_idx == 0).reshape(-1)
        targets = self.target_variables if self.target_variables \
            else latent_uuids
        samples = {u: chain[u][:, cold] for u in targets}
        # swap acceptance per adjacent pair, averaged over chains and
        # sweeps (each pair proposes on alternate sweeps)
        prop = torch.stack(proposing).to(dtype)
        acc = torch.stack(swaps).to(dtype)
        pair_acc = torch.sum(acc, dim=0) / torch.clamp(
            torch.sum(prop, dim=0), min=1.0)                  # (R,)
        pair_acc = torch.mean(pair_acc.reshape(C, K), dim=0)[:-1]
        diagnostics = {
            "accept_rate": torch.mean(torch.stack(accept_probs),
                                      dim=0).reshape(C, K)[:, 0],
            "swap_accept_rate": pair_acc,                     # (K-1,)
            "step_size": eps,
            "betas": betas_k,
        }
        return samples, diagnostics


class ParallelTemperingInference(Inference):
    """The inference: ``run(**data)`` returns cold-chain samples {uuid:
    (S, C, *event)} and stores ``.diagnostics`` (per-pair swap
    acceptance = the ladder-health signal)."""

    def run(self, generator=None, **kwargs):
        samples, diagnostics = super().run(generator=generator, **kwargs)
        self.diagnostics = {k: _as_numpy(v) for k, v in diagnostics.items()}
        self.diagnostics.update(_chain_convergence_diagnostics(samples))
        self._samples = samples
        return samples


ParallelTemperingInference.sample_predictive = \
    HMCInference.sample_predictive
