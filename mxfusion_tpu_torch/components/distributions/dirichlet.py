"""Dirichlet distribution.

Counterpart of ``mxfusion_tpu/components/distributions/dirichlet.py``.
``normalization=True`` renormalizes the random variable before
evaluating the density; a draw normalizes Gamma draws.
"""
import torch

from .distribution import Distribution
from ..variables.variable import Variable


class Dirichlet(Distribution):

    support = "simplex"

    def __init__(self, alpha, normalization=True, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("alpha", alpha)], outputs=None,
            input_names=["alpha"], output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)
        self.normalization = normalization

    def log_pdf_impl(self, random_variable, alpha):
        x = random_variable
        if self.normalization:
            x = x / torch.sum(x, dim=-1, keepdim=True)
        log_norm = (torch.sum(torch.lgamma(alpha), dim=-1)
                    - torch.lgamma(torch.sum(alpha, dim=-1)))
        return torch.sum((alpha - 1.0) * torch.log(x), dim=-1) - log_norm

    def draw_samples_impl(self, rv_shape, num_samples, generator, alpha):
        shape = (num_samples,) + rv_shape
        g = self._rand_gen.sample_gamma(
            generator, alpha=torch.broadcast_to(alpha, shape), beta=1.0,
            shape=shape, dtype=self.dtype)
        return g / torch.sum(g, dim=-1, keepdim=True)

    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        replica.normalization = self.normalization
        return replica

    def _generate_outputs(self, shape):
        if shape is None:
            raise ValueError("Dirichlet requires an explicit shape.")
        self.set_outputs([Variable(shape=shape)])

    @classmethod
    def define_variable(cls, alpha, shape=None, normalization=True,
                        rand_gen=None, dtype=None):
        dist = cls(alpha=alpha, normalization=normalization,
                   rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
