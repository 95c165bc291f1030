"""Wishart distribution.

Counterpart of ``mxfusion_tpu/components/distributions/wishart.py``. A
draw is the Bartlett factor built batched: a strictly lower triangular
standard-normal matrix plus a diagonal of chi draws (one normal draw,
one gamma draw, no loops), times the scale's Cholesky factor.
"""
import math

import torch

from .distribution import Distribution
from ..variables.variable import Variable
from ...ops.linalg import cholesky
from ...util.special import (log_determinant, log_multivariate_gamma,
                             solve_posdef, trace)

LOG2 = math.log(2.0)


class Wishart(Distribution):
    """Wishart over PSD matrices: ``degrees_of_freedom`` and ``scale``.
    Every factorization is ``ops.linalg.cholesky``'s: a scale or random
    variable that is not positive definite gives NaN, as in JAX."""

    #: rows of one matrix draw
    row_separable = False

    def __init__(self, degrees_of_freedom, scale, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("degrees_of_freedom", degrees_of_freedom),
                    ("scale", scale)],
            outputs=None,
            input_names=["degrees_of_freedom", "scale"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, degrees_of_freedom, scale):
        X = random_variable
        D = X.shape[-1]
        n = degrees_of_freedom.to(X.dtype)
        # a dof declared with a trailing (1,) event dim
        while n.ndim > X.ndim - 2:
            n = n[..., 0]
        logdet_X = log_determinant(X)
        logdet_S = log_determinant(scale)
        tr = trace(solve_posdef(scale, X))
        return (0.5 * (n - D - 1.0) * logdet_X - 0.5 * tr
                - 0.5 * n * D * LOG2 - 0.5 * n * logdet_S
                - log_multivariate_gamma(0.5 * n, D))

    def draw_samples_impl(self, rv_shape, num_samples, generator,
                          degrees_of_freedom, scale):
        D = rv_shape[-1]
        n = degrees_of_freedom
        while n.ndim > 1:
            n = n[..., 0]
        shape = (num_samples,) + tuple(rv_shape)
        # Bartlett: A = strict_lower(N(0,1)) + diag(sqrt(chi2(n - i)))
        N = self._rand_gen.sample_normal(generator, shape=shape,
                                         dtype=self.dtype)
        strict_lower = torch.tril(N, diagonal=-1)
        i = torch.arange(D, dtype=N.dtype, device=N.device)
        df = torch.broadcast_to(n[..., None] - i, shape[:-2] + (D,))
        chi2 = 2.0 * self._rand_gen.sample_gamma(
            generator, alpha=0.5 * df, beta=1.0, shape=df.shape,
            dtype=self.dtype)
        # the diagonal set out of place: strict_lower's diagonal is 0
        A = strict_lower + torch.diag_embed(torch.sqrt(chi2))
        # factor the scale once and broadcast the factor
        L = torch.broadcast_to(cholesky(scale), shape)
        LA = torch.einsum("...ij,...jk->...ik", L, A)
        return torch.einsum("...ik,...jk->...ij", LA, LA)

    def _generate_outputs(self, shape):
        if shape is None:
            raise ValueError("Wishart requires an explicit shape.")
        self.set_outputs([Variable(shape=shape)])

    @classmethod
    def define_variable(cls, degrees_of_freedom, scale, shape=None,
                        rand_gen=None, dtype=None):
        dist = cls(degrees_of_freedom=degrees_of_freedom, scale=scale,
                   rand_gen=rand_gen, dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
