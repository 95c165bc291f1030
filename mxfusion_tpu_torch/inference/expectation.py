"""Monte-Carlo expectation algorithms.

Counterpart of ``mxfusion_tpu/inference/expectation.py``.
"""
import torch

from .inference_alg import SamplingAlgorithm
from ..components.variables.runtime_variable import expectation
from ..components.variables.variable import VariableType


class ExpectationAlgorithm(SamplingAlgorithm):
    """Expectation of model variables under forward sampling."""

    def compute(self, env, ctx):
        samples = self.model.draw_samples(
            env, ctx.next_generator(), num_samples=self.num_samples)
        samples = {k: expectation(v) for k, v in samples.items()}
        if self.target_variables:
            return tuple(samples[v] for v in self.target_variables)
        return samples


class ExpectationScoreFunctionAlgorithm(SamplingAlgorithm):
    """Score-function gradient of an arbitrary loss variable in the model.

    The target variable is a deterministic function of sampled latents;
    its expectation is differentiated via the likelihood-ratio trick.
    As in the JAX package, a reparameterized sampling path (the gamma
    draw's implicit gradient among them) adds its pathwise gradient as
    well, so those latents count twice.
    """

    def compute(self, env, ctx):
        samples = self.model.draw_samples(
            env, ctx.next_generator(), num_samples=self.num_samples)
        env.update(samples)
        targets = [v for v in self.model.get_latent_variables(
            self.observed_variable_UUIDs)
            if v.type == VariableType.RANDVAR]
        q_z = self.model.log_pdf_per_sample(env, targets=targets)
        p_xz = env[self.target_variables[0]]
        p_xz = torch.sum(p_xz, dim=tuple(range(1, p_xz.ndim))) \
            if p_xz.ndim > 1 else p_xz
        gradient_lambda = torch.mean(q_z * p_xz.detach(), dim=0)
        gradient_theta = torch.mean(p_xz, dim=0)
        gradient_log_L = gradient_lambda + gradient_theta
        return gradient_theta, gradient_log_L
