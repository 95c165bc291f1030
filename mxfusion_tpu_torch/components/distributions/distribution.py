"""Distribution base class.

Counterpart of ``mxfusion_tpu/components/distributions/distribution.py``.
Runtime contract:

- ``log_pdf(env)`` fetches inputs and the output random variable from a
  UUID-keyed env of tensors, broadcasts them to a common sample count
  on axis 0, and calls ``log_pdf_impl``; the result is scaled by
  ``log_pdf_scaling`` (minibatch rescaling) or, where the executor set
  ``log_pdf_scaling_key``, by the env's array under that key (an
  observation mask).
- ``draw_samples(env, generator, num_samples)`` realizes the output
  variable's (possibly symbolic) shape against the env's shape
  constants and calls ``draw_samples_impl`` with an explicit
  ``torch.Generator``.
- ``define_variable(...)`` is the user-facing constructor that builds
  the factor and returns its output random variable.
"""
import torch

from ..factor import Factor
from ..variables.variable import Variable
from ..variables.runtime_variable import (arrays_as_samples,
                                          align_sample_arrays)
from .random_gen import default_rand_gen
from ...common.config import get_default_dtype
from ...util.inference import realize_shape


class Distribution(Factor):
    """Base class of all probability distributions."""

    #: rows are independent draws (the event's last axes)
    row_separable = True

    # elementwise distributions right-align parameter event dims against
    # the random variable (scalar params vs (N, 1) values)
    _elementwise = False
    # Support of the output variable: "real" (default), "positive",
    # "unit_interval", or "simplex" (last event axis). Samplers, MAP and
    # the meanfield factory use it to run constrained latents in an
    # unconstrained space; every distribution declares it.
    support = "real"

    def __init__(self, inputs, outputs, input_names, output_names,
                 rand_gen=None, dtype=None):
        super().__init__(inputs=inputs, outputs=outputs,
                         input_names=input_names, output_names=output_names)
        self._rand_gen = rand_gen if rand_gen is not None else default_rand_gen()
        self.dtype = dtype if dtype is not None else get_default_dtype()
        self.log_pdf_scaling = 1.0

    @property
    def rand_gen(self):
        return self._rand_gen

    @property
    def random_variable(self):
        return self.outputs[0][1]

    # ------------------------------------------------------------------
    def log_pdf(self, env):
        """Per-sample log density of the output variable under this factor.

        Returns a tensor with a leading sample axis; the factor-graph
        interpreter sums over event dims and averages over samples.
        """
        inputs = self.fetch_runtime_inputs(env)
        rv = env[self.random_variable.uuid]
        broadcast = arrays_as_samples(list(inputs.values()) + [rv])
        if self._elementwise:
            broadcast = align_sample_arrays(broadcast)
        named = dict(zip(inputs.keys(), broadcast[:-1]))
        # an array rv_scaling (observation mask or per-point weights)
        # rides the env; a scalar one is the attribute (the minibatch
        # N/B correction)
        scaling = self.log_pdf_scaling
        scale_key = getattr(self, "log_pdf_scaling_key", None)
        if scale_key is not None and scale_key in env:
            scaling = env[scale_key]
        return self.log_pdf_impl(random_variable=broadcast[-1], **named) \
            * scaling

    def draw_samples(self, env, generator, num_samples=1):
        """Draw ``num_samples`` samples of the output variable."""
        inputs = self.fetch_runtime_inputs(env)
        rv_shape = realize_shape(self.random_variable.shape, env)
        broadcast = arrays_as_samples(list(inputs.values()))
        if self._elementwise:
            # align parameter event dims against the output event shape
            rank = 1 + len(rv_shape)
            broadcast = [
                torch.reshape(a, (a.shape[0],) + (1,) * (rank - a.ndim)
                              + tuple(a.shape[1:]))
                if isinstance(a, torch.Tensor) and 1 <= a.ndim < rank
                else a
                for a in broadcast]
        named = dict(zip(inputs.keys(), broadcast))
        return self.draw_samples_impl(rv_shape=rv_shape,
                                      num_samples=num_samples,
                                      generator=generator, **named)

    # subclasses implement:
    def log_pdf_impl(self, random_variable, **inputs):
        raise NotImplementedError

    def draw_samples_impl(self, rv_shape, num_samples, generator, **inputs):
        raise NotImplementedError

    # ------------------------------------------------------------------
    def _generate_outputs(self, shape):
        self.set_outputs([Variable(shape=shape if shape is not None else (1,))])

    @classmethod
    def define_variable(cls, shape=None, rand_gen=None, dtype=None, **kwargs):
        """Create the factor and return its output random variable."""
        dist = cls(rand_gen=rand_gen, dtype=dtype, **kwargs)
        dist._generate_outputs(shape=shape)
        return dist.random_variable

    # ------------------------------------------------------------------
    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        replica._rand_gen = self._rand_gen
        replica.dtype = self.dtype
        replica.log_pdf_scaling = 1.0
        return replica


class UnivariateDistribution(Distribution):
    """Distributions whose event shape defaults to ``(1,)``."""

    _elementwise = True
