"""ChEES-HMC: self-tuning trajectory lengths.

Counterpart of ``mxfusion_tpu/inference/chees.py`` (Hoffman, Radul &
Sountsov 2021). All chains share one jittered trajectory length whose
distribution is adapted by maximizing the Change in the Estimator of
the Expected Squared jump distance

    ChEES = 1/4 E[ (‖q⁺−μ‖² − ‖q−μ‖²)² ]

by Adam on log T, with the criterion's gradient estimated across the
chains on the sample axis. The step size co-adapts by dual averaging
toward ``target_accept`` on the harmonic-mean accept statistic. Metric:
identity.

Each proposal's trip count ``clip(ceil(u·T/ε), 1, max_leapfrog)`` is one
host integer, shared by all chains, so the leapfrog is a plain loop.

One deliberate difference from the JAX package: a chain whose proposal
is accepted with probability 0 adds nothing to the ChEES gradient (its
jump counts as none, its velocity as 0). In JAX such a proposal enters
the cross-chain mean with weight 0 but with its value, so a diverged
trajectory (an overflowed q⁺) makes the gradient, and from then on the
trajectory length, NaN, and every later proposal takes one leapfrog
step. Wherever JAX's gradient is finite, the two agree.
"""
import torch

from .inference import Inference
from .inference_alg import SamplingAlgorithm
from .hmc import (HMCInference, _chain_convergence_diagnostics,
                  _dual_averaging, _dual_averaging_start, _hmc_transition,
                  _log_uniform, _normal_draws, _stack, _as_numpy,
                  detached_env, init_chains_from_prior, log_posterior,
                  make_support_transforms, sampler_latent_uuids,
                  value_and_grad)

# Adam on log T
_ADAM_B1, _ADAM_B2, _ADAM_LR = 0.9, 0.95, 0.025


def _trip_count(traj_frac, T, eps, max_leapfrog):
    """Leapfrog steps of one proposal, a host integer:
    ``clip(ceil(traj_frac·T/ε), 1, max_leapfrog)``."""
    n = float(torch.ceil(traj_frac * T / eps))
    return int(min(max(n, 1.0), max_leapfrog))


def _chees_gradient(q, q1, v1, accept_prob, traj_frac, latent_uuids):
    """d ChEES / d T estimated across chains (paper eq. 6): each chain's
    ``(‖q⁺−μ‖²−‖q−μ‖²)·(q⁺−μ)ᵀv⁺·u`` weighted by its acceptance
    probability. A chain accepted with probability 0 counts at q with
    velocity 0 (see the module docstring)."""
    C = accept_prob.shape[0]
    live = (accept_prob > 0).reshape(C, 1)

    def flat(z):
        return torch.cat([z[u].reshape(C, -1) for u in latent_uuids], dim=1)

    cq = flat(q)
    cq1 = torch.where(live, flat(q1), cq)
    v = torch.where(live, flat(v1), torch.zeros_like(cq))
    cq = cq - torch.mean(cq, dim=0, keepdim=True)
    cq1 = cq1 - torch.mean(cq1, dim=0, keepdim=True)
    jump = torch.sum(cq1 ** 2, dim=1) - torch.sum(cq ** 2, dim=1)
    term = jump * torch.sum(cq1 * v, dim=1) * traj_frac
    w = accept_prob / (torch.sum(accept_prob) + 1e-12)
    return torch.sum(w * term)


def _adam_ascent(log_T, m, v, grad, it, eps, max_leapfrog):
    """One Adam ASCENT step on log T along the ChEES gradient, kept
    inside [log ε, log ε·max_leapfrog] (ε the step size the proposal
    used); ``it`` counts the steps, this one included."""
    m = _ADAM_B1 * m + (1.0 - _ADAM_B1) * grad
    v = _ADAM_B2 * v + (1.0 - _ADAM_B2) * grad ** 2
    mh = m / (1.0 - _ADAM_B1 ** it)
    vh = v / (1.0 - _ADAM_B2 ** it)
    log_T = log_T + _ADAM_LR * mh / (torch.sqrt(vh) + 1e-8)
    log_T = torch.clamp(log_T, torch.log(eps),
                        torch.log(eps * max_leapfrog))
    return log_T, m, v


class ChEESHMCAlgorithm(SamplingAlgorithm):
    """ChEES-adaptive HMC over the model's latent RANDVARs.

    Parameters
    ----------
    num_samples, num_warmup, num_chains : int
    step_size : float
        Initial leapfrog step (dual-averaged during warmup).
    trajectory_length : float
        Initial mean trajectory length T (adapted during warmup).
    target_accept : float
    max_leapfrog : int
        Hard cap on leapfrog steps per proposal.

    ``compute`` returns ``(samples, diagnostics)`` with the same
    contract as HMCAlgorithm; diagnostics add the adapted trajectory
    length and mean leapfrog count.
    """

    def __init__(self, model, observed, num_samples=500, num_warmup=500,
                 num_chains=8, step_size=0.1, trajectory_length=1.0,
                 target_accept=0.651, max_leapfrog=256,
                 target_variables=None, extra_graphs=None):
        super().__init__(model=model, observed=observed,
                         num_samples=num_samples,
                         target_variables=target_variables,
                         extra_graphs=extra_graphs)
        self.num_warmup = num_warmup
        self.num_chains = num_chains
        self.step_size = step_size
        self.trajectory_length = trajectory_length
        self.target_accept = target_accept
        self.max_leapfrog = max_leapfrog

    #: every potential goes through value_and_grad (see HMCAlgorithm)
    reduces_over_data = True

    def _latent_uuids(self):
        return sampler_latent_uuids(self, "ChEES-HMC")

    def compute(self, env, ctx):
        C = self.num_chains
        latent_uuids = self._latent_uuids()
        env = detached_env(env)
        generator = ctx.next_generator()
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

        def proposal(q, U, g, eps, T):
            """One jittered-trajectory proposal for all chains:
            traj_frac ~ U(0, 1), n = ceil(traj_frac·T/ε)."""
            traj_frac = torch.rand((), generator=generator, dtype=dtype,
                                   device=device)
            p0 = _normal_draws(q, generator)
            log_u = _log_uniform(C, generator, dtype, device)
            n_steps = _trip_count(traj_frac, T, eps, self.max_leapfrog)
            out = _hmc_transition(q, U, g, p0, log_u, eps, None, n_steps,
                                  potential)
            return out, traj_frac, n_steps

        with torch.no_grad():
            U, g = potential(q)
            # ---- warmup: dual averaging on eps + Adam on log T
            eps0 = torch.as_tensor(self.step_size, dtype=dtype,
                                   device=device)
            mu = torch.log(10.0 * eps0)
            state = _dual_averaging_start(eps0)
            log_T = torch.log(torch.as_tensor(self.trajectory_length,
                                              dtype=dtype, device=device))
            mT = torch.zeros((), dtype=dtype, device=device)
            vT = torch.zeros((), dtype=dtype, device=device)
            for _ in range(self.num_warmup):
                eps = torch.exp(state[0])
                T = torch.exp(log_T)
                (qn, Un, gn, accept_prob, _, (q1, v1)), traj_frac, _ = \
                    proposal(q, U, g, eps, T)
                # harmonic-mean accept statistic (paper): robust to a
                # few stuck chains
                mean_accept = 1.0 / torch.mean(1.0 / (accept_prob + 1e-6))
                state = _dual_averaging(state, mean_accept,
                                        self.target_accept, mu)
                grad = _chees_gradient(q, q1, v1, accept_prob, traj_frac,
                                       latent_uuids) * T
                log_T, mT, vT = _adam_ascent(log_T, mT, vT, grad, state[3],
                                             eps, self.max_leapfrog)
                q, U, g = qn, Un, gn
            eps = torch.exp(state[1])
            T = torch.exp(log_T)

            # ---- sampling at fixed (eps, T), still jittered
            draws, accept_probs, n_steps = [], [], []
            for _ in range(self.num_samples):
                out, _, n = proposal(q, U, g, eps, T)
                q, U, g, accept_prob = out[:4]
                draws.append(q)
                accept_probs.append(accept_prob)
                n_steps.append(n)
            chain = _stack(draws)
            if bij is not None:
                chain = bij.constrain(chain)  # back to the native support
        targets = self.target_variables if self.target_variables \
            else latent_uuids
        samples = {u: chain[u] for u in targets}
        diagnostics = {
            "accept_rate": torch.mean(torch.stack(accept_probs), dim=0),
            "step_size": eps,
            "trajectory_length": T,
            "mean_leapfrog_steps": torch.mean(torch.as_tensor(
                n_steps, dtype=dtype, device=device)),
        }
        return samples, diagnostics


class ChEESHMCInference(Inference):
    """The inference: ``run(**data)`` returns the posterior sample dict and
    stores ``.diagnostics`` (accept rate, adapted step size and
    trajectory length, mean leapfrog steps, split R-hat)."""

    def run(self, generator=None, **kwargs):
        samples, diagnostics = super().run(generator=generator, **kwargs)
        self.diagnostics = {k: _as_numpy(v) for k, v in diagnostics.items()}
        self.diagnostics.update(_chain_convergence_diagnostics(samples))
        self._samples = samples
        return samples


ChEESHMCInference.sample_predictive = HMCInference.sample_predictive
