"""Stick-breaking (logistic-)normal distribution on the simplex.

Counterpart of
``mxfusion_tpu/components/distributions/stickbreaking_normal.py``: the
pathwise-reparameterizable simplex family the mean-field builder assigns
to simplex-support latents. ``z ~ Normal(mean, variance)`` in R^(K-1),
``x = stick_breaking(z)`` on the K-simplex (``ops/simplex.py``), with
the change-of-variables Jacobian inside the density.
"""
import math

import torch

from .distribution import Distribution
from ..variables.variable import Variable
from ...ops import simplex as simplex_ops

_LOG2PI = math.log(2.0 * math.pi)


class StickBreakingNormal(Distribution):
    """``x = stick_breaking(z)``, ``z ~ N(mean, variance)`` in
    R^(K-1); the event (simplex) axis is the LAST axis, ``mean`` and
    ``variance`` have a K-1 last axis."""

    support = "simplex"

    def __init__(self, mean, variance, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("mean", mean), ("variance", variance)], outputs=None,
            input_names=["mean", "variance"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, mean, variance):
        z = simplex_ops.inverse(random_variable)       # (..., K-1)
        log_q_z = -0.5 * torch.sum(
            _LOG2PI + torch.log(variance) + (z - mean) ** 2 / variance,
            dim=-1)
        # density w.r.t. the simplex: p(x) = p_z(z(x)) / |dx/dz|
        return log_q_z - simplex_ops.log_det_jacobian(z)

    def draw_samples_impl(self, rv_shape, num_samples, generator, mean,
                          variance):
        z_shape = (num_samples,) + rv_shape[:-1] + (rv_shape[-1] - 1,)
        z = self._rand_gen.sample_normal(
            generator, loc=mean, scale=torch.sqrt(variance), shape=z_shape,
            dtype=self.dtype)
        return simplex_ops.forward(z)

    def _generate_outputs(self, shape):
        if shape is None:
            raise ValueError(
                "StickBreakingNormal requires an explicit shape "
                "(the K-simplex axis is the last event axis).")
        self.set_outputs([Variable(shape=shape)])

    @classmethod
    def define_variable(cls, mean, variance, shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(mean=mean, variance=variance, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
