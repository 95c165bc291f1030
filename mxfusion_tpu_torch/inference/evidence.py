"""Model evidence by thermodynamic integration (power posteriors).

Counterpart of ``mxfusion_tpu/inference/evidence.py``. The log marginal
likelihood is

    log Z = ∫_0^1 E_{pi_beta}[ log p(y | x) ] dbeta,
    pi_beta(x) ∝ p(x) · p(y | x)^beta            (Gelman & Meng 1998;
                                                  Friel & Pettitt 2008)

— the path from prior (beta = 0) to posterior (beta = 1). Every rung of
the Friel-Pettitt schedule beta_k = (k / (K-1))^c runs as a replica on
the sample axis, with LIKELIHOOD-ONLY tempering; adjacent rungs swap
states for mixing, and the per-rung mean log-likelihood is averaged over
the sampling sweeps. The integral is the trapezoid over the ladder.

The sweep keeps the JAX package's own rules, which are not plain HMC's:
a per-rung step scale (0.25 + beta)^-1/2, a fresh gradient at the start
of each leapfrog trajectory, per-replica dual averaging, swaps decided by
the likelihood alone, rows laid out chain-major with the beta = 1 rung
first. The scans become Python loops with every carried tensor
detached, as in the other samplers. A sweep of L leapfrog steps
evaluates the potential L + 1 times (each one forward over the C·K
replicas and one backward); over a GP module each evaluation is one K1
launch of (C·K, N, N).

The sweeps' random draws (momenta, acceptance and swap uniforms) come
from a ``RandomGenerator`` (``rand_gen``), so a test can replay another
package's draws through ``FixedRandomGenerator``.
"""
import numpy as np
import torch

from .inference import Inference
from .inference_alg import SamplingAlgorithm, VariableEnv
from .hmc import (_as_numpy, _chain_convergence_diagnostics,
                  _dual_averaging, _dual_averaging_start, _hmc_transition,
                  _rows, _stack, detached_env, init_chains_from_prior,
                  make_support_transforms, sampler_latent_uuids,
                  sum_log_pdf_terms, value_and_grad)
from .tempering import _swap_pass
from ..components.distributions.random_gen import default_rand_gen


class PowerPosteriorAlgorithm(SamplingAlgorithm):
    """HMC over the full power-posterior ladder with replica swaps.

    Parameters mirror ParallelTemperingAlgorithm; ``num_temps`` is the
    number of rungs K (including beta = 0 and beta = 1) and
    ``schedule_power`` the Friel-Pettitt exponent c (rungs concentrate
    near 0, where the integrand changes fastest). ``rand_gen`` draws the
    sweeps' momenta and uniforms on the run's generator (default: the
    library's generator).

    ``compute`` returns ``(samples, diagnostics)``: posterior
    (beta = 1) samples {uuid: (S, C, *event)}; diagnostics carry
    ``log_evidence`` (trapezoid TI estimate), ``betas``,
    ``mean_loglik_per_temp``, the swap acceptance per pair, and
    ``potential_evaluations``.
    """

    def __init__(self, model, observed, num_samples=500, num_warmup=500,
                 num_chains=2, num_temps=16, schedule_power=5.0,
                 step_size=0.1, num_leapfrog=16, target_accept=0.8,
                 target_variables=None, extra_graphs=None, rand_gen=None):
        super().__init__(model=model, observed=observed,
                         num_samples=num_samples,
                         target_variables=target_variables,
                         extra_graphs=extra_graphs)
        if num_temps < 2:
            raise ValueError("num_temps must be >= 2 (the TI grid "
                             "needs beta = 0 and beta = 1).")
        self.num_warmup = num_warmup
        self.num_chains = num_chains
        self.num_temps = num_temps
        self.schedule_power = schedule_power
        self.step_size = step_size
        self.num_leapfrog = num_leapfrog
        self.target_accept = target_accept
        self.rand_gen = rand_gen if rand_gen is not None \
            else default_rand_gen()

    def _latent_uuids(self):
        return sampler_latent_uuids(self, "PowerPosterior")

    def ladder(self, dtype, device):
        """The replicas' betas (C·K,): the Friel-Pettitt schedule with
        its endpoints, chain-major, coldest (beta = 1) first so that row
        r % K == 0 is the posterior rung."""
        return torch.as_tensor(
            np.linspace(1.0, 0.0, self.num_temps) ** self.schedule_power,
            dtype=dtype, device=device).repeat(self.num_chains)

    def potential_parts(self, env, ctx, bij, dtype):
        """``log_parts(q) -> (log prior + Jacobian, log likelihood)``,
        each (C·K,), at replica states ``q`` in sampling space: the two
        halves of every rung's potential -(prior + beta · likelihood).
        One call is one density evaluation over all the replicas."""
        latent_uuids = self._latent_uuids()
        lik_targets = [u for u in self.observed_variable_UUIDs
                       if self.model.variables[u].factor is not None]

        def log_parts(q):
            e = VariableEnv(env)
            e.update(bij.constrain(q) if bij is not None else q)
            lik = sum_log_pdf_terms(
                self.model.log_pdf_terms(e, targets=lik_targets, ctx=ctx),
                dtype)
            pri = sum_log_pdf_terms(
                self.model.log_pdf_terms(e, targets=latent_uuids, ctx=ctx),
                dtype)
            if bij is not None:
                pri = pri + bij.log_jacobian(q).to(dtype)
            return pri, lik
        return log_parts

    def compute(self, env, ctx):
        C, K = self.num_chains, self.num_temps
        R = C * K
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

        betas = self.ladder(dtype, device)                 # (R,)
        betas_k = betas[:K]
        t_idx = torch.arange(K, device=device).repeat(C)   # (R,)
        # the beta=0 rung targets the prior: bounded step scaling
        eps_scale = (0.25 + betas) ** -0.5                 # (R,)
        parts = self.potential_parts(env, ctx, bij, dtype)
        evaluations = [0]

        def log_parts(q):
            """(log prior + Jacobian, log likelihood), each (R,)."""
            evaluations[0] += 1
            return parts(q)

        def sweep(q, pri, lik, eps):
            """One HMC proposal for every replica at its rung's target,
            on this sweep's draws. Returns (q, pri, lik, accept_prob)."""
            p0 = {u: self.rand_gen.sample_normal(
                generator, shape=tuple(q[u].shape), dtype=dtype)
                for u in latent_uuids}
            log_u = torch.log(self.rand_gen.sample_uniform(
                generator, shape=(R,), dtype=dtype))
            end = {}

            def potential(x):
                """(U, grad U) at x; the endpoint's parts kept."""
                def U(x):
                    pri, lik = log_parts(x)
                    end["pri"], end["lik"] = pri.detach(), lik.detach()
                    return -(pri + betas * lik)
                return value_and_grad(U, x)

            # a fresh gradient at the start of the trajectory
            _, g = potential(q)
            step = {u: _rows(eps * eps_scale, q[u]) for u in q}
            qn, _, _, accept_prob, accept, _ = _hmc_transition(
                q, -(pri + betas * lik), g, p0, log_u, step, None,
                self.num_leapfrog, potential)
            return (qn, torch.where(accept, end["pri"], pri),
                    torch.where(accept, end["lik"], lik), accept_prob)

        def swap(q, pri, lik, parity):
            """Adjacent-rung swaps; the ratio uses the LIKELIHOOD only
            (the prior factor is common to both rungs), and the prior
            terms move with the states."""
            u = self.rand_gen.sample_uniform(generator, shape=(R,),
                                             dtype=dtype)
            q, lik, moved, do_swap, is_lower = _swap_pass(
                q, lik, {"pri": pri}, betas, t_idx, K, parity,
                torch.log(u))
            return q, moved["pri"], lik, do_swap, is_lower

        with torch.no_grad():
            pri, lik = log_parts(q)
            # ---- warmup: per-replica dual averaging of the base step.
            # Every rung's target has its own curvature (beta=1
            # sharpest), so each adapts its own step size
            eps0 = torch.full((R,), self.step_size, dtype=dtype,
                              device=device)
            mu = torch.log(10.0 * eps0[0])
            state = _dual_averaging_start(eps0)
            for i in range(self.num_warmup):
                q, pri, lik, accept_prob = sweep(q, pri, lik,
                                                 torch.exp(state[0]))
                q, pri, lik, _, _ = swap(q, pri, lik, i % 2)
                state = _dual_averaging(state, accept_prob.to(dtype),
                                        self.target_accept, mu)
            eps = torch.exp(state[1])

            # ---- sampling sweeps: posterior-rung states and the
            # per-replica loglik for the TI average
            draws, liks, accept_probs, swaps, proposed = [], [], [], [], []
            for i in range(self.num_samples):
                q, pri, lik, accept_prob = sweep(q, pri, lik, eps)
                q, pri, lik, do_swap, is_lower = swap(q, pri, lik, i % 2)
                draws.append(q)
                liks.append(lik)
                accept_probs.append(accept_prob)
                swaps.append(do_swap)
                proposed.append(is_lower)
            chain = _stack(draws)
            if bij is not None:
                chain = bij.constrain(chain)
        cold = torch.nonzero(t_idx == 0)[:, 0]
        targets = self.target_variables if self.target_variables \
            else latent_uuids
        samples = {u: torch.index_select(chain[u], 1, cold)
                   for u in targets}

        # TI: mean loglik per rung (sweeps x chains pooled), trapezoid
        # over beta ascending
        mean_lik = torch.mean(torch.stack(liks).reshape(
            self.num_samples, C, K), dim=(0, 1))             # (K,)
        order = torch.argsort(betas_k)                       # ascending
        b_asc = betas_k[order]
        l_asc = mean_lik[order]
        log_Z = torch.sum(0.5 * (l_asc[1:] + l_asc[:-1])
                          * (b_asc[1:] - b_asc[:-1]))
        prop = torch.stack(proposed).to(dtype)
        acc = torch.stack(swaps).to(dtype)
        pair_acc = (torch.sum(acc, dim=0) /
                    torch.clamp(torch.sum(prop, dim=0), min=1.0))
        pair_acc = torch.mean(pair_acc.reshape(C, K), dim=0)[:-1]
        diagnostics = {
            "log_evidence": log_Z,
            "betas": betas_k,
            "mean_loglik_per_temp": mean_lik,
            "accept_rate": torch.mean(torch.stack(accept_probs),
                                      dim=0).reshape(C, K)[:, 0],
            "swap_accept_rate": pair_acc,
            "step_size": eps,
            "potential_evaluations": evaluations[0],
        }
        return samples, diagnostics


class PowerPosteriorInference(Inference):
    """The inference: ``run(**data)`` returns posterior-rung samples and
    stores ``.diagnostics`` incl. ``log_evidence`` (also exposed as
    ``.log_evidence`` after the run)."""

    def run(self, generator=None, **kwargs):
        samples, diagnostics = super().run(generator=generator, **kwargs)
        self.diagnostics = {k: _as_numpy(v) for k, v in diagnostics.items()}
        self.diagnostics.update(_chain_convergence_diagnostics(samples))
        self.log_evidence = float(self.diagnostics["log_evidence"])
        self._samples = samples
        return samples
