"""Log-normal distribution.

Counterpart of ``mxfusion_tpu/components/distributions/lognormal.py``.
Parameterized by the mean/variance of the underlying normal in log
space (matching ``scipy.stats.lognorm(s=sqrt(var), scale=exp(mean))``).
The mean-field builder assigns it to positive-support latents.
"""
import math

import torch

from .distribution import UnivariateDistribution


class LogNormal(UnivariateDistribution):
    """``log(x) ~ Normal(mean, variance)``."""

    support = "positive"

    def __init__(self, mean, variance, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("mean", mean), ("variance", variance)], outputs=None,
            input_names=["mean", "variance"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, mean, variance):
        logx = torch.log(random_variable)
        return (-0.5 * torch.log(2.0 * math.pi * variance) - logx
                - 0.5 * (logx - mean) ** 2 / variance)

    def draw_samples_impl(self, rv_shape, num_samples, generator, mean,
                          variance):
        z = self._rand_gen.sample_normal(
            generator, loc=mean, scale=torch.sqrt(variance),
            shape=(num_samples,) + rv_shape, dtype=self.dtype)
        return torch.exp(z)

    @classmethod
    def define_variable(cls, mean=0., variance=1., shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(mean=mean, variance=variance, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
