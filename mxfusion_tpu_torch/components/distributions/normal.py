"""Normal-family distributions.

Counterpart of ``mxfusion_tpu/components/distributions/normal.py`` (so
far the univariate ``Normal``; the multivariate classes come with the
batched-Cholesky kernel they call).
"""
import math

import torch

from .distribution import UnivariateDistribution


LOG2PI = math.log(2.0 * math.pi)


class Normal(UnivariateDistribution):
    """Normal distribution parameterized by mean and variance."""

    support = "real"

    def __init__(self, mean, variance, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("mean", mean), ("variance", variance)], outputs=None,
            input_names=["mean", "variance"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, mean, variance):
        return -0.5 * (LOG2PI + torch.log(variance)
                       + (random_variable - mean) ** 2 / variance)

    def draw_samples_impl(self, rv_shape, num_samples, generator, mean,
                          variance):
        # reparameterized: mean + sqrt(var) * eps
        eps = self._rand_gen.sample_normal(
            generator, shape=(num_samples,) + rv_shape, dtype=self.dtype)
        return mean + torch.sqrt(variance) * eps

    @classmethod
    def define_variable(cls, mean=0., variance=1., shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(mean=mean, variance=variance, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
