"""Finite Gaussian mixture with marginalized assignments.

Counterpart of ``mxfusion_tpu/components/distributions/mixture.py``.
The component assignment is marginalized inside ``log_pdf`` (a
``logsumexp`` over a trailing component axis), so the density is smooth
in every parameter. The component axis is the LAST axis of ``weights``,
``means`` and ``variances`` (shape ``(..., K)``); the random variable has
the event shape without it.
"""
import math

import torch

from .distribution import UnivariateDistribution

_LOG2PI = math.log(2.0 * math.pi)


class NormalMixture(UnivariateDistribution):
    """``p(x) = Σ_k w_k N(x | mean_k, var_k)``, ``w`` renormalized here
    (place a ``PositiveTransformation`` on trainable weights)."""

    def __init__(self, weights, means, variances, rand_gen=None,
                 dtype=None):
        super().__init__(
            inputs=[("weights", weights), ("means", means),
                    ("variances", variances)],
            outputs=None,
            input_names=["weights", "means", "variances"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    @staticmethod
    def _align(p, target_ndim):
        """Right-align a (sample, ..., K) parameter against x[..., None]:
        keep axis 0 (samples) and the trailing component axis, pad
        broadcast axes in between."""
        while p.ndim < target_ndim:
            p = torch.unsqueeze(p, 1)
        return p

    def log_pdf_impl(self, random_variable, weights, means, variances):
        x = torch.unsqueeze(random_variable, -1)            # (..., 1)
        weights = self._align(weights, x.ndim)
        means = self._align(means, x.ndim)
        variances = self._align(variances, x.ndim)
        w = weights / torch.sum(weights, dim=-1, keepdim=True)
        comp = -0.5 * (_LOG2PI + torch.log(variances)
                       + (x - means) ** 2 / variances)      # (..., K)
        return torch.logsumexp(comp + torch.log(w), dim=-1)

    def draw_samples_impl(self, rv_shape, num_samples, generator, weights,
                          means, variances):
        w = weights / torch.sum(weights, dim=-1, keepdim=True)
        shape = (num_samples,) + rv_shape
        # align as in log_pdf_impl before broadcasting, so that the
        # parameters' sample axis meets the draws' sample axis
        target = len(shape) + 1
        w = self._align(w, target)
        means = self._align(means, target)
        variances = self._align(variances, target)
        probs = torch.broadcast_to(w, shape + w.shape[-1:])
        idx = self._rand_gen.sample_multinomial(generator, probs)
        idx = idx[..., None].to(torch.int64)
        mean_b = torch.broadcast_to(means, shape + means.shape[-1:])
        var_b = torch.broadcast_to(variances, shape + variances.shape[-1:])
        mean_sel = torch.gather(mean_b, -1, idx)[..., 0]
        var_sel = torch.gather(var_b, -1, idx)[..., 0]
        return self._rand_gen.sample_normal(
            generator, loc=mean_sel, scale=torch.sqrt(var_sel), shape=shape,
            dtype=self.dtype)

    @classmethod
    def define_variable(cls, weights, means, variances, shape=None,
                        rand_gen=None, dtype=None):
        dist = cls(weights=weights, means=means, variances=variances,
                   rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
