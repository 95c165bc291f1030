"""Student-t distribution (location/scale/degrees-of-freedom).

Counterpart of ``mxfusion_tpu/components/distributions/studentt.py``.
A draw takes its chi-square from the gamma draw, whose gradient in the
degrees of freedom is the implicit one.
"""
import math

import torch

from .distribution import UnivariateDistribution


class StudentT(UnivariateDistribution):
    """Student-t with ``degrees_of_freedom`` nu, ``location`` and
    ``scale``: ``x = location + scale · t_nu``."""

    def __init__(self, degrees_of_freedom, location, scale, rand_gen=None,
                 dtype=None):
        super().__init__(
            inputs=[("degrees_of_freedom", degrees_of_freedom),
                    ("location", location), ("scale", scale)],
            outputs=None,
            input_names=["degrees_of_freedom", "location", "scale"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, degrees_of_freedom, location,
                     scale):
        nu = degrees_of_freedom
        z = (random_variable - location) / scale
        return (torch.lgamma((nu + 1.0) / 2.0) - torch.lgamma(nu / 2.0)
                - 0.5 * torch.log(nu * math.pi) - torch.log(scale)
                - (nu + 1.0) / 2.0 * torch.log1p(z * z / nu))

    def draw_samples_impl(self, rv_shape, num_samples, generator,
                          degrees_of_freedom, location, scale):
        return self._rand_gen.sample_studentt(
            generator, degrees_of_freedom=degrees_of_freedom,
            location=location, scale=scale,
            shape=(num_samples,) + rv_shape, dtype=self.dtype)

    @classmethod
    def define_variable(cls, degrees_of_freedom=3., location=0., scale=1.,
                        shape=None, rand_gen=None, dtype=None):
        dist = cls(degrees_of_freedom=degrees_of_freedom, location=location,
                   scale=scale, rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
