"""Uniform distribution.

Counterpart of ``mxfusion_tpu/components/distributions/uniform.py``.
"""
import math

import torch

from .distribution import UnivariateDistribution


class Uniform(UnivariateDistribution):
    def __init__(self, low, high, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("low", low), ("high", high)], outputs=None,
            input_names=["low", "high"], output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, low, high):
        inside = (random_variable >= low) & (random_variable <= high)
        log_p = -torch.log(high - low)
        log_p, inside = torch.broadcast_tensors(log_p, inside)
        return torch.where(inside, log_p,
                           torch.full_like(log_p, -math.inf))

    def draw_samples_impl(self, rv_shape, num_samples, generator, low, high):
        return self._rand_gen.sample_uniform(
            generator, low=low, high=high, shape=(num_samples,) + rv_shape,
            dtype=self.dtype)

    @classmethod
    def define_variable(cls, low=0., high=1., shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(low=low, high=high, rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
