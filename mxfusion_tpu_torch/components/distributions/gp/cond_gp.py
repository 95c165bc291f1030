"""ConditionalGaussianProcess distribution.

Counterpart of ``mxfusion_tpu/components/distributions/gp/cond_gp.py``.
Density/sampling of GP function values at X conditioned on observations
(X_cond, Y_cond):

    p(f|X, X_cond, Y_cond) = N(K_xz K_zz⁻¹ Y_cond,
                               K_xx − K_xz K_zz⁻¹ K_zx)

All solves go through one Cholesky of K_zz.
"""
import math

import torch

from .gp import _add_jitter
from ..distribution import Distribution
from ...variables.variable import Variable
from ....ops.linalg import cholesky
from ....ops.precision import einsum as p_einsum

LOG2PI = math.log(2.0 * math.pi)


class ConditionalGaussianProcess(Distribution):

    #: the GP couples its rows through K
    row_separable = False
    def __init__(self, X, X_cond, Y_cond, kernel, mean=None, mean_cond=None,
                 rand_gen=None, dtype=None, jitter=0.0):
        inputs = [("X", X), ("X_cond", X_cond), ("Y_cond", Y_cond)] + \
            [(n, v) for n, v in kernel.parameters.items()]
        input_names = [n for n, _ in inputs]
        self.has_mean = mean is not None
        self.has_mean_cond = mean_cond is not None
        if self.has_mean:
            inputs.append(("mean", mean))
            input_names.append("mean")
        if self.has_mean_cond:
            inputs.append(("mean_cond", mean_cond))
            input_names.append("mean_cond")
        self.kernel = kernel
        self.jitter = jitter
        super().__init__(inputs=inputs, outputs=None,
                         input_names=input_names,
                         output_names=["random_variable"],
                         rand_gen=rand_gen, dtype=dtype)

    def _kernel_args(self, inputs):
        return {n: inputs[n] for n in self.kernel.parameter_names}

    def _conditional_moments(self, X, X_cond, Y_cond, inputs):
        kp = self._kernel_args(inputs)
        if self.has_mean_cond:
            Y_cond = Y_cond - inputs["mean_cond"]
        Kzz = _add_jitter(self.kernel.K(X_cond, **kp), self.jitter)
        Kxz = self.kernel.K(X, X2=X_cond, **kp)
        Kxx = self.kernel.K(X, **kp)
        Lz = cholesky(Kzz)
        # A = Lz^{-1} K_zx : (..., M, N)
        A = torch.linalg.solve_triangular(Lz, Kxz.transpose(-1, -2),
                                          upper=False)
        LinvY = torch.linalg.solve_triangular(Lz, Y_cond, upper=False)
        mean = p_einsum("...mn,...md->...nd", A, LinvY)
        cov = Kxx - p_einsum("...mn,...mk->...nk", A, A)
        if self.has_mean:
            mean = mean + inputs["mean"]
        return mean, cov

    def log_pdf_impl(self, random_variable, X, X_cond, Y_cond, **inputs):
        mean, cov = self._conditional_moments(X, X_cond, Y_cond, inputs)
        L = cholesky(_add_jitter(cov, self.jitter))
        diff = random_variable - mean
        alpha = torch.linalg.solve_triangular(L, diff, upper=False)
        N = diff.shape[-2]
        Dout = diff.shape[-1]
        logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)
        return (-0.5 * N * Dout * LOG2PI - Dout * logdet
                - 0.5 * torch.sum(torch.square(alpha), dim=(-2, -1)))

    def draw_samples_impl(self, rv_shape, num_samples, generator, X, X_cond,
                          Y_cond, **inputs):
        mean, cov = self._conditional_moments(X, X_cond, Y_cond, inputs)
        L = cholesky(_add_jitter(cov, self.jitter))
        eps = self._rand_gen.sample_normal(
            generator, shape=(num_samples,) + rv_shape, dtype=self.dtype)
        return mean + p_einsum("...ij,...jk->...ik", L, eps)

    def _generate_outputs(self, shape):
        if shape is None:
            raise ValueError(
                "ConditionalGaussianProcess requires an explicit shape.")
        self.set_outputs([Variable(shape=shape)])

    @classmethod
    def define_variable(cls, X, X_cond, Y_cond, kernel, shape=None, mean=None,
                        mean_cond=None, rand_gen=None, dtype=None,
                        jitter=0.0):
        gp = cls(X=X, X_cond=X_cond, Y_cond=Y_cond, kernel=kernel, mean=mean,
                 mean_cond=mean_cond, rand_gen=rand_gen, dtype=dtype,
                 jitter=jitter)
        gp._generate_outputs(shape=shape)
        return gp.random_variable

    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        replica.kernel = self.kernel.replicate_self(attribute_map)
        replica.has_mean = self.has_mean
        replica.has_mean_cond = self.has_mean_cond
        replica.jitter = self.jitter
        return replica
