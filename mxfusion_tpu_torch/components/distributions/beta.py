"""Beta distribution.

Counterpart of ``mxfusion_tpu/components/distributions/beta.py``. A draw
is ``g/(g+h)`` of two Gamma draws through the rand_gen facade, ``g``
first, so the generator (and the test double) are consumed in the JAX
package's order.
"""
import torch

from .distribution import UnivariateDistribution


class Beta(UnivariateDistribution):

    support = "unit_interval"

    def __init__(self, alpha, beta, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("alpha", alpha), ("beta", beta)], outputs=None,
            input_names=["alpha", "beta"], output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, alpha, beta):
        log_beta_fn = (torch.lgamma(alpha) + torch.lgamma(beta)
                       - torch.lgamma(alpha + beta))
        return ((alpha - 1.0) * torch.log(random_variable)
                + (beta - 1.0) * torch.log1p(-random_variable) - log_beta_fn)

    def draw_samples_impl(self, rv_shape, num_samples, generator, alpha,
                          beta):
        shape = (num_samples,) + rv_shape
        g = self._rand_gen.sample_gamma(
            generator, alpha=torch.broadcast_to(alpha, shape), beta=1.0,
            shape=shape, dtype=self.dtype)
        h = self._rand_gen.sample_gamma(
            generator, alpha=torch.broadcast_to(beta, shape), beta=1.0,
            shape=shape, dtype=self.dtype)
        return g / (g + h)

    @classmethod
    def define_variable(cls, alpha=1., beta=1., shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(alpha=alpha, beta=beta, rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
