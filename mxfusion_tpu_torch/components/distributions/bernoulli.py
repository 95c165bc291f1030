"""Bernoulli distribution.

Counterpart of ``mxfusion_tpu/components/distributions/bernoulli.py``.
The draw is boolean, as in JAX, and is cast to the factor's dtype.
"""
import torch

from .distribution import UnivariateDistribution
from ...common.config import as_torch_dtype


class Bernoulli(UnivariateDistribution):
    """Bernoulli with success probability ``prob_true``."""

    # discrete: no bijector, as the JAX package's (inherited) "real"
    support = "real"

    def __init__(self, prob_true, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("prob_true", prob_true)], outputs=None,
            input_names=["prob_true"], output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, prob_true):
        x = random_variable.to(prob_true.dtype)
        return x * torch.log(prob_true) + (1.0 - x) * torch.log1p(-prob_true)

    def draw_samples_impl(self, rv_shape, num_samples, generator, prob_true):
        shape = (num_samples,) + rv_shape
        b = self._rand_gen.sample_bernoulli(
            generator, prob_true=torch.broadcast_to(prob_true, shape),
            shape=shape)
        return b.to(as_torch_dtype(self.dtype))

    @classmethod
    def define_variable(cls, prob_true=0.5, shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(prob_true=prob_true, rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
