"""Normal-family distributions.

Counterpart of ``mxfusion_tpu/components/distributions/normal.py``:
``Normal``, ``MultivariateNormal``, ``NormalMeanPrecision`` and
``MultivariateNormalMeanPrecision``. The multivariate log-pdfs and draws
factor their covariance or precision through
:func:`~mxfusion_tpu_torch.ops.batched_cholesky.cholesky`, which takes
the batched Cholesky kernel (K4) on the card.

Shape conventions (leading axis = samples):
- univariate: mean/variance/rv broadcast elementwise.
- multivariate: mean ``(s, ..., D)``, covariance ``(s, ..., D, D)``,
  rv ``(s, ..., D)``; log_pdf returns ``(s, ...)``.
"""
import math

import torch

from .distribution import Distribution, UnivariateDistribution
from ..variables.variable import Variable
from ...ops.batched_cholesky import cholesky as _cholesky
from ...ops.precision import einsum as p_einsum


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


class MultivariateNormal(Distribution):
    """MVN parameterized by mean and covariance matrix."""

    support = "real"

    def __init__(self, mean, covariance, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("mean", mean), ("covariance", covariance)], outputs=None,
            input_names=["mean", "covariance"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, mean, covariance):
        D = random_variable.shape[-1]
        L = _cholesky(covariance)
        diff = random_variable - mean
        alpha = torch.linalg.solve_triangular(
            L, diff[..., None], upper=False)[..., 0]
        logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)
        return (-0.5 * D * LOG2PI - logdet
                - 0.5 * torch.sum(alpha ** 2, dim=-1))

    def draw_samples_impl(self, rv_shape, num_samples, generator, mean,
                          covariance):
        L = _cholesky(covariance)
        eps = self._rand_gen.sample_normal(
            generator, shape=(num_samples,) + rv_shape, dtype=self.dtype)
        return mean + p_einsum("...ij,...j->...i", L, eps)

    @classmethod
    def define_variable(cls, mean, covariance, shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(mean=mean, covariance=covariance, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable

    def _generate_outputs(self, shape):
        if shape is None:
            raise ValueError("MultivariateNormal requires an explicit shape.")
        self.set_outputs([Variable(shape=shape)])


class NormalMeanPrecision(UnivariateDistribution):
    """Normal parameterized by mean and precision (1/variance)."""

    support = "real"

    def __init__(self, mean, precision, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("mean", mean), ("precision", precision)], outputs=None,
            input_names=["mean", "precision"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, mean, precision):
        return 0.5 * (torch.log(precision) - LOG2PI
                      - precision * (random_variable - mean) ** 2)

    def draw_samples_impl(self, rv_shape, num_samples, generator, mean,
                          precision):
        eps = self._rand_gen.sample_normal(
            generator, shape=(num_samples,) + rv_shape, dtype=self.dtype)
        return mean + eps / torch.sqrt(precision)

    @classmethod
    def define_variable(cls, mean=0., precision=1., shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(mean=mean, precision=precision, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable


class MultivariateNormalMeanPrecision(Distribution):
    """MVN parameterized by mean and precision matrix.

    log N(x|μ, Λ⁻¹) = ½log|Λ| − D/2·log2π − ½(x−μ)ᵀΛ(x−μ); sampling maps
    ε through the inverse transpose Cholesky of Λ.
    """

    support = "real"

    def __init__(self, mean, precision, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("mean", mean), ("precision", precision)], outputs=None,
            input_names=["mean", "precision"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, mean, precision):
        D = random_variable.shape[-1]
        L = _cholesky(precision)
        logdet = 2.0 * torch.sum(
            torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        diff = random_variable - mean
        # (x−μ)ᵀΛ(x−μ) as two HIGHEST products (JAX: one 3-operand einsum)
        quad = p_einsum("...i,...i->...", diff,
                        p_einsum("...ij,...j->...i", precision, diff))
        return 0.5 * (logdet - D * LOG2PI - quad)

    def draw_samples_impl(self, rv_shape, num_samples, generator, mean,
                          precision):
        L = _cholesky(precision)
        eps = self._rand_gen.sample_normal(
            generator, shape=(num_samples,) + rv_shape, dtype=self.dtype)
        # x = mean + L^{-T} eps  has covariance (L L^T)^{-1} = Λ^{-1}; the
        # solve broadcasts the factor against the sample batch
        z = torch.linalg.solve_triangular(
            L.transpose(-1, -2), eps[..., None], upper=True)[..., 0]
        return mean + z

    @classmethod
    def define_variable(cls, mean, precision, shape=None, rand_gen=None,
                        dtype=None):
        dist = cls(mean=mean, precision=precision, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable

    def _generate_outputs(self, shape):
        if shape is None:
            raise ValueError(
                "MultivariateNormalMeanPrecision requires an explicit shape.")
        self.set_outputs([Variable(shape=shape)])
