"""Logit-normal distribution.

Counterpart of ``mxfusion_tpu/components/distributions/logitnormal.py``:
the unit-interval member of the transformed-normal family. The
mean-field builder assigns it to unit-interval latents; its draws are
reparameterized (the sigmoid of an affine of standard normal noise), so
SVI gradients are pathwise.
"""
import math

import torch

from .distribution import UnivariateDistribution


class LogitNormal(UnivariateDistribution):
    """``logit(x) ~ Normal(mean, variance)`` on ``x in (0, 1)``."""

    support = "unit_interval"

    def __init__(self, mean, variance, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("mean", mean), ("variance", variance)], outputs=None,
            input_names=["mean", "variance"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, mean, variance):
        x = random_variable
        z = torch.log(x) - torch.log1p(-x)
        return (-0.5 * torch.log(2.0 * math.pi * variance)
                - torch.log(x) - torch.log1p(-x)
                - 0.5 * (z - mean) ** 2 / variance)

    def draw_samples_impl(self, rv_shape, num_samples, generator, mean,
                          variance):
        z = self._rand_gen.sample_normal(
            generator, loc=mean, scale=torch.sqrt(variance),
            shape=(num_samples,) + rv_shape, dtype=self.dtype)
        return torch.sigmoid(z)

    @classmethod
    def define_variable(cls, mean=0., variance=1., shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(mean=mean, variance=variance, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
