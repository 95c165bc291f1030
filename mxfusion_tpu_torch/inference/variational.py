"""Variational inference algorithms.

Counterpart of ``mxfusion_tpu/inference/variational.py``.
``StochasticVariationalInference`` is the reparameterized ELBO: sample
the posterior, evaluate ``log p − log q`` on the same env (model and
posterior share variable UUIDs by replication), negate. Autograd takes
the pathwise gradient through the sampled values.
"""
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
