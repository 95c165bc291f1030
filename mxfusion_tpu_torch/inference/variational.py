"""Variational inference algorithms.

Counterpart of ``mxfusion_tpu/inference/variational.py``.
``StochasticVariationalInference`` is the reparameterized ELBO: sample
the posterior, evaluate ``log p − log q`` on the same env (model and
posterior share variable UUIDs by replication), negate. Autograd takes
the pathwise gradient through the sampled values.
"""
import math

import torch

from .inference_alg import InferenceAlgorithm, SamplingAlgorithm


class VariationalInference(InferenceAlgorithm):
    """Base class holding the (model, posterior) pair."""

    def __init__(self, num_samples, model, posterior, observed):
        super().__init__(model=model, observed=observed,
                         extra_graphs=[posterior] if posterior is not None
                         else [])
        self.num_samples = num_samples

    @property
    def posterior(self):
        return self._extra_graphs[0] if self._extra_graphs else None


class VariationalSamplingAlgorithm(SamplingAlgorithm):
    """Base for sampling algorithms conditioned on a variational posterior."""

    def __init__(self, model, posterior, observed, num_samples=1,
                 target_variables=None):
        super().__init__(model=model, observed=observed,
                         num_samples=num_samples,
                         target_variables=target_variables,
                         extra_graphs=[posterior] if posterior is not None
                         else [])

    @property
    def posterior(self):
        return self._extra_graphs[0] if self._extra_graphs else None


class StochasticVariationalInference(VariationalInference):
    """Reparameterized ELBO."""

    def compute(self, env, ctx):
        samples = self.posterior.draw_samples(
            env, ctx.next_generator(), num_samples=self.num_samples)
        env.update(samples)
        logL = self.model.log_pdf(env, ctx=ctx) - \
            self.posterior.log_pdf(env, ctx=ctx)
        return -logL, -logL


class ImportanceWeightedVariationalInference(VariationalInference):
    """Multi-sample importance-weighted bound (IWAE, Burda et al. 2016).

        L_S = E[ log (1/S) Σ_s p(x, z_s) / q(z_s) ],  z_s ~ q

    is tighter than the ELBO, monotone in ``num_samples``, and tends to
    log p(x) as S grows. The S samples ride the leading sample axis:
    one batched density evaluation, and autograd takes the IWAE
    pathwise gradient."""

    def compute(self, env, ctx):
        samples = self.posterior.draw_samples(
            env, ctx.next_generator(), num_samples=self.num_samples)
        env.update(samples)
        logw = self.model.log_pdf_per_sample(env, ctx=ctx) - \
            self.posterior.log_pdf_per_sample(env, ctx=ctx)
        bound = torch.logsumexp(logw, dim=0) - \
            math.log(float(self.num_samples))
        return -bound, -bound
