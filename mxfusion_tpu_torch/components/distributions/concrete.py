"""Concrete (Gumbel-Softmax) distribution.

Counterpart of ``mxfusion_tpu/components/distributions/concrete.py``.
A reparameterized relaxation of a one-hot code: a draw is
``softmax((log p + Gumbel) / tau)`` on the interior of the simplex, and
the density has the closed form (Maddison et al. 2017)

    p(x) = (K-1)! tau^{K-1} (Π_k p_k x_k^{-tau-1}) / (Σ_k p_k x_k^{-tau})^K
"""
import math

import torch

from .distribution import Distribution
from ..variables.variable import Variable


class Concrete(Distribution):
    """Concrete / Gumbel-Softmax on the (K-1)-simplex: ``probs``
    (normalized here) and a float ``temperature``; the event shape's
    last axis holds the K classes."""

    # density on the simplex: samplers reparameterize it through the
    # stick-breaking bijector, as Dirichlet
    support = "simplex"

    def __init__(self, probs, temperature=1.0, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("probs", probs)], outputs=None,
            input_names=["probs"], output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)
        self.temperature = float(temperature)

    def replicate_self(self, attribute_map=None):
        rep = super().replicate_self(attribute_map)
        rep.temperature = self.temperature
        return rep

    def log_pdf_impl(self, random_variable, probs):
        x = random_variable
        K = x.shape[-1]
        tau = self.temperature
        logp = torch.log(probs / torch.sum(probs, dim=-1, keepdim=True))
        logx = torch.log(x)
        return (math.lgamma(float(K)) + (K - 1) * math.log(tau)
                + torch.sum(logp - (tau + 1.0) * logx, dim=-1)
                - K * torch.logsumexp(logp - tau * logx, dim=-1))

    def draw_samples_impl(self, rv_shape, num_samples, generator, probs):
        logp = torch.log(probs / torch.sum(probs, dim=-1, keepdim=True))
        u = self._rand_gen.sample_uniform(
            generator, shape=(num_samples,) + rv_shape, dtype=self.dtype)
        gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-20, 1.0 - 1e-7)))
        return torch.softmax((logp + gumbel) / self.temperature, dim=-1)

    def _generate_outputs(self, shape=None):
        if shape is None:
            raise ValueError("Concrete needs an explicit shape "
                             "(..., num_classes).")
        self.set_outputs([Variable(shape=shape)])

    @classmethod
    def define_variable(cls, probs, shape, temperature=1.0,
                        rand_gen=None, dtype=None):
        dist = cls(probs=probs, temperature=temperature,
                   rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
