"""Stein variational gradient descent (SVGD, Liu & Wang 2016).

Counterpart of ``mxfusion_tpu/inference/svgd.py``. Particle-based
inference that interpolates between MAP (1 particle) and a full
posterior approximation: n particles follow the kernelized Stein flow

    z_i += eps * (1/n) Σ_j [ k(z_j, z_i) ∇_{z_j} log p(z_j, x)
                             + ∇_{z_j} k(z_j, z_i) ]

with an RBF kernel whose bandwidth follows the median heuristic.
Particles ride the leading sample axis, so the joint log-density of all
particles is one batched ``log_pdf_per_sample`` call and one gradient
per iteration; the particle-particle kernel is an (n, n) matrix over the
flattened particles. SVGD is deterministic after its initial draw.
"""
import numpy as np
import torch

from .inference import Inference
from .inference_alg import SamplingAlgorithm, VariableEnv
from .hmc import (HMCInference, _as_numpy, detached_env,
                  init_chains_from_prior, make_support_transforms,
                  sampler_latent_uuids, value_and_grad)


def _median(x):
    """The median of every entry of ``x``, averaging the two middle
    values of an even count, as ``jnp.median`` does (``torch.median``
    returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    k = s.shape[0]
    return (s[(k - 1) // 2] + s[k // 2]) * 0.5


def _stein_direction(zf, g, bandwidth):
    """φ(z_i) = (1/n) Σ_j [k(z_j, z_i) g_j + ∇_{z_j} k(z_j, z_i)] for
    flattened particles ``zf`` (n, D) and their scores ``g`` (n, D);
    ``bandwidth`` None takes the median heuristic h = med²/log(n+1)."""
    n = zf.shape[0]
    d2 = torch.sum((zf[:, None, :] - zf[None, :, :]) ** 2, dim=-1)
    if bandwidth is None:
        h = _median(d2) / np.log(n + 1.0) + 1e-8
    else:
        h = torch.as_tensor(bandwidth, dtype=zf.dtype,
                            device=zf.device) ** 2
    K = torch.exp(-d2 / h)                  # (n, n)
    # Σ_j K_ji ∇_j log p + ∇_j k(z_j, z_i)
    drive = K @ g
    repulse = (torch.sum(K, dim=0)[:, None] * zf - K @ zf) * (2.0 / h)
    return (drive + repulse) / n


def _svgd_step(zf, G, p, eps):
    """The RMSProp-EMA step: G ← 0.9·G + 0.1·φ², z ← z + ε·φ/(1e-6+√G).
    Returns (z, G)."""
    G = 0.9 * G + 0.1 * p ** 2
    return zf + eps * p / (1e-6 + torch.sqrt(G)), G


class SVGDAlgorithm(SamplingAlgorithm):
    """SVGD over the model's latent RANDVARs.

    Parameters
    ----------
    num_particles : int
        Particles (vectorized on the sample axis, prior-initialized).
    num_iterations : int
    step_size : float
        Master step; per-coordinate scaled by an RMSProp EMA of the
        squared updates (eps / (1e-6+sqrt(G))), decayed as
        ``(1 + t/tau) ** -0.5``.
    bandwidth : float or None
        RBF bandwidth h; ``None`` uses the median heuristic
        ``h = med²/log(n+1)`` recomputed every iteration.

    ``compute`` returns ``(particles, diagnostics)``: particles is
    {uuid: (num_particles, *event_shape)}.
    """

    def __init__(self, model, observed, num_particles=50,
                 num_iterations=500, step_size=1e-1, bandwidth=None,
                 target_variables=None, extra_graphs=None):
        super().__init__(model=model, observed=observed,
                         num_samples=num_particles,
                         target_variables=target_variables,
                         extra_graphs=extra_graphs)
        self.num_particles = num_particles
        self.num_iterations = num_iterations
        self.step_size = step_size
        self.bandwidth = bandwidth

    #: every potential goes through value_and_grad (see HMCAlgorithm)
    reduces_over_data = True

    def _latent_uuids(self):
        return sampler_latent_uuids(self, "SVGD")

    def compute(self, env, ctx):
        n = self.num_particles
        latent_uuids = self._latent_uuids()
        env = detached_env(env)
        z = init_chains_from_prior(self.model, env, ctx.next_generator(),
                                   latent_uuids, n)
        bij = make_support_transforms(self.model, latent_uuids)
        if bij is not None:
            z = bij.unconstrain(z)  # particles flow in z-space
        dtype = z[latent_uuids[0]].dtype
        shapes = {u: tuple(z[u].shape[1:]) for u in z}
        sizes = {u: int(np.prod(shapes[u])) for u in z}

        def flat(z):
            return torch.cat([z[u].reshape(n, -1) for u in latent_uuids],
                             dim=1)

        def unflat(zf):
            out, i = {}, 0
            for u in latent_uuids:
                out[u] = zf[:, i:i + sizes[u]].reshape((n,) + shapes[u])
                i += sizes[u]
            return out

        def log_joint(zd):
            e = VariableEnv(env)
            e.update(bij.constrain(zd) if bij is not None else zd)
            lp = torch.sum(self.model.log_pdf_per_sample(e, ctx=ctx)
                           .to(dtype))
            if bij is not None:
                lp = lp + torch.sum(bij.log_jacobian(zd)).to(dtype)
            return lp

        with torch.no_grad():
            zf = flat(z)
            G = torch.zeros_like(zf)
            eps0 = torch.as_tensor(self.step_size, dtype=dtype,
                                   device=zf.device)
            tau = max(1.0, self.num_iterations / 4.0)
            update = None
            for t in range(self.num_iterations):
                # the (n, D) batched score
                _, g = value_and_grad(lambda d: log_joint(unflat(d["zf"])),
                                      {"zf": zf}, ctx.data_reduction)
                p = _stein_direction(zf, g["zf"], self.bandwidth)
                eps = eps0 * (1.0 + t / tau) ** -0.5
                zf, G = _svgd_step(zf, G, p, eps)
                update = torch.mean(torch.abs(p))
            particles = unflat(zf)
            if bij is not None:
                particles = bij.constrain(particles)
        targets = self.target_variables if self.target_variables \
            else latent_uuids
        # the last update's magnitude: no extra gradient after the loop
        diagnostics = {"final_mean_abs_update": update}
        return {u: particles[u] for u in targets}, diagnostics


class SVGDInference(Inference):
    """The inference: ``run(**data)`` returns {uuid: (num_particles, *event)}
    and stores ``.diagnostics``."""

    def run(self, generator=None, **kwargs):
        particles, diagnostics = super().run(generator=generator, **kwargs)
        self.diagnostics = {k: _as_numpy(v) for k, v in diagnostics.items()}
        self._samples = particles
        return particles

    def sample_predictive(self, generator=None, samples=None, targets=None,
                          **data):
        """Posterior-predictive draws with latents pinned to the
        particles: particles carry no chain axis, so insert one and
        delegate to the shared (HMC) implementation."""
        if samples is None:
            samples = getattr(self, "_samples", None)
        if samples is not None:
            samples = {u: torch.as_tensor(a)[:, None]
                       for u, a in samples.items()}
        return HMCInference.sample_predictive(
            self, generator=generator, samples=samples, targets=targets,
            **data)
