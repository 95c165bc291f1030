"""Gamma distributions (shape/rate and mean/variance parameterizations).

Counterpart of ``mxfusion_tpu/components/distributions/gamma.py``.
Draws go through ``RandomGenerator.sample_gamma``, whose backward is the
implicit reparameterization gradient.
"""
import torch

from .distribution import UnivariateDistribution


def _gamma_log_pdf(x, alpha, beta):
    return (alpha * torch.log(beta) + (alpha - 1.0) * torch.log(x)
            - beta * x - torch.lgamma(alpha))


class Gamma(UnivariateDistribution):
    """Gamma with shape ``alpha`` and rate ``beta``."""

    support = "positive"

    def __init__(self, alpha, beta, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("alpha", alpha), ("beta", beta)], outputs=None,
            input_names=["alpha", "beta"], output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, alpha, beta):
        return _gamma_log_pdf(random_variable, alpha, beta)

    def draw_samples_impl(self, rv_shape, num_samples, generator, alpha,
                          beta):
        shape = (num_samples,) + rv_shape
        return self._rand_gen.sample_gamma(
            generator, alpha=torch.broadcast_to(alpha, shape), beta=beta,
            shape=shape, dtype=self.dtype)

    @classmethod
    def define_variable(cls, alpha=1., beta=1., shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(alpha=alpha, beta=beta, rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable


class GammaMeanVariance(UnivariateDistribution):
    """Gamma parameterized by mean and variance: ``alpha = mean²/var``,
    ``beta = mean/var``."""

    support = "positive"

    def __init__(self, mean, variance, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("mean", mean), ("variance", variance)], outputs=None,
            input_names=["mean", "variance"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    @staticmethod
    def _to_alpha_beta(mean, variance):
        beta = mean / variance
        alpha = mean * beta
        return alpha, beta

    def log_pdf_impl(self, random_variable, mean, variance):
        alpha, beta = self._to_alpha_beta(mean, variance)
        return _gamma_log_pdf(random_variable, alpha, beta)

    def draw_samples_impl(self, rv_shape, num_samples, generator, mean,
                          variance):
        alpha, beta = self._to_alpha_beta(mean, variance)
        shape = (num_samples,) + rv_shape
        return self._rand_gen.sample_gamma(
            generator, alpha=torch.broadcast_to(alpha, shape), beta=beta,
            shape=shape, dtype=self.dtype)

    @classmethod
    def define_variable(cls, mean=1., variance=1., shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(mean=mean, variance=variance, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
