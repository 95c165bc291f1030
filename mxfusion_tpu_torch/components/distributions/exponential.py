"""Exponential distribution (rate parameterization).

Counterpart of ``mxfusion_tpu/components/distributions/exponential.py``.
"""
import torch

from .distribution import UnivariateDistribution


class Exponential(UnivariateDistribution):
    """Exponential with rate ``rate``: ``p(x) = rate * exp(-rate x)``."""

    support = "positive"

    def __init__(self, rate, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("rate", rate)], outputs=None,
            input_names=["rate"], output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, rate):
        lp = torch.log(rate) - rate * random_variable
        return torch.where(random_variable >= 0, lp,
                           torch.full_like(lp, -torch.inf))

    def draw_samples_impl(self, rv_shape, num_samples, generator, rate):
        return self._rand_gen.sample_exponential(
            generator, rate=rate, shape=(num_samples,) + rv_shape,
            dtype=self.dtype)

    @classmethod
    def define_variable(cls, rate=1., shape=None, rand_gen=None, dtype=None):
        dist = cls(rate=rate, rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
