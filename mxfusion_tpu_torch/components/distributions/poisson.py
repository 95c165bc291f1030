"""Poisson distribution.

Counterpart of ``mxfusion_tpu/components/distributions/poisson.py``.
The random variable holds counts in the factor's float dtype, so that it
composes with float pipelines.
"""
import torch

from .distribution import UnivariateDistribution


class Poisson(UnivariateDistribution):
    """Poisson with rate ``rate``."""

    def __init__(self, rate, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("rate", rate)], outputs=None,
            input_names=["rate"], output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, rate):
        return (random_variable * torch.log(rate) - rate
                - torch.lgamma(random_variable + 1.0))

    def draw_samples_impl(self, rv_shape, num_samples, generator, rate):
        return self._rand_gen.sample_poisson(
            generator, rate=rate, shape=(num_samples,) + rv_shape,
            dtype=self.dtype)

    @classmethod
    def define_variable(cls, rate=1., shape=None, rand_gen=None, dtype=None):
        dist = cls(rate=rate, rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
