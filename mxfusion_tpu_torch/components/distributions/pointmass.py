"""PointMass distribution (MAP's posterior factor).

Counterpart of ``mxfusion_tpu/components/distributions/pointmass.py``.
``log_pdf`` is identically zero; sampling returns the location.
"""
import torch

from .distribution import UnivariateDistribution


class PointMass(UnivariateDistribution):
    def __init__(self, location, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("location", location)], outputs=None,
            input_names=["location"], output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, location):
        return torch.zeros_like(random_variable)

    def draw_samples_impl(self, rv_shape, num_samples, generator, location):
        return torch.broadcast_to(location, (num_samples,) + rv_shape)

    @classmethod
    def define_variable(cls, location, shape=None, rand_gen=None, dtype=None):
        dist = cls(location=location, rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
