"""Laplace distribution.

Counterpart of ``mxfusion_tpu/components/distributions/laplace.py``.
"""
import torch

from .distribution import UnivariateDistribution


class Laplace(UnivariateDistribution):
    def __init__(self, location, scale, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("location", location), ("scale", scale)], outputs=None,
            input_names=["location", "scale"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, location, scale):
        return (-torch.log(2.0 * scale)
                - torch.abs(random_variable - location) / scale)

    def draw_samples_impl(self, rv_shape, num_samples, generator, location,
                          scale):
        return self._rand_gen.sample_laplace(
            generator, location=location, scale=scale,
            shape=(num_samples,) + rv_shape, dtype=self.dtype)

    @classmethod
    def define_variable(cls, location=0., scale=1., shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(location=location, scale=scale, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
