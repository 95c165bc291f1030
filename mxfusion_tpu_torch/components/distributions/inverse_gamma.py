"""Inverse-Gamma distribution.

Counterpart of ``mxfusion_tpu/components/distributions/inverse_gamma.py``:
the conjugate prior of a Gaussian variance.
"""
import torch

from .distribution import UnivariateDistribution


class InverseGamma(UnivariateDistribution):
    """``x ~ InvGamma(alpha, beta)``: ``1/x ~ Gamma(alpha, rate=beta)``;
    ``p(x) = beta^alpha / Γ(alpha) x^-(alpha+1) exp(-beta/x)``."""

    support = "positive"

    def __init__(self, alpha, beta, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("alpha", alpha), ("beta", beta)], outputs=None,
            input_names=["alpha", "beta"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, alpha, beta):
        return (alpha * torch.log(beta) - torch.lgamma(alpha)
                - (alpha + 1.0) * torch.log(random_variable)
                - beta / random_variable)

    def draw_samples_impl(self, rv_shape, num_samples, generator, alpha,
                          beta):
        shape = (num_samples,) + rv_shape
        g = self._rand_gen.sample_gamma(
            generator, alpha=torch.broadcast_to(alpha, shape), beta=1.0,
            shape=shape, dtype=self.dtype)
        return beta / g

    @classmethod
    def define_variable(cls, alpha=1., beta=1., shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(alpha=alpha, beta=beta, rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
