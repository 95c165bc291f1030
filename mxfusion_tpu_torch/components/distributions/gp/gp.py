"""GaussianProcess distribution: joint MVN of function values at X.

Counterpart of ``mxfusion_tpu/components/distributions/gp/gp.py``.
Kernel parameters are graph inputs, so gradients reach lengthscales and
variances through the Cholesky. Output columns are independent GPs
sharing the kernel matrix (one Cholesky, all columns in one batched
triangular solve).
"""
import math

import torch

from ..distribution import Distribution
from ...variables.variable import Variable
from ....ops.precision import einsum as p_einsum

LOG2PI = math.log(2.0 * math.pi)


def _add_jitter(K, jitter):
    if jitter > 0:
        K = K + jitter * torch.eye(K.shape[-1], dtype=K.dtype,
                                   device=K.device)
    return K


class GaussianProcess(Distribution):
    """``f ~ GP(mean, kernel)`` evaluated at inputs ``X``.

    The factor's inputs are ``X``, optionally ``mean``, plus every kernel
    parameter under its prefixed name.
    """

    def __init__(self, X, kernel, mean=None, rand_gen=None, dtype=None,
                 jitter=0.0):
        inputs = [("X", X)] + [(n, v) for n, v in kernel.parameters.items()]
        input_names = [n for n, _ in inputs]
        self.has_mean = mean is not None
        if self.has_mean:
            inputs.append(("mean", mean))
            input_names.append("mean")
        self.kernel = kernel
        self.jitter = jitter
        super().__init__(inputs=inputs, outputs=None,
                         input_names=input_names,
                         output_names=["random_variable"],
                         rand_gen=rand_gen, dtype=dtype)

    # ------------------------------------------------------------------
    def _kernel_args(self, inputs):
        return {n: inputs[n] for n in self.kernel.parameter_names}

    def log_pdf_impl(self, random_variable, X, **inputs):
        rv = random_variable
        if self.has_mean:
            rv = rv - inputs["mean"]
        K = _add_jitter(self.kernel.K(X, **self._kernel_args(inputs)),
                        self.jitter)
        L = torch.linalg.cholesky(K)
        alpha = torch.linalg.solve_triangular(L, rv, upper=False)
        N = rv.shape[-2]
        logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)
        Dout = rv.shape[-1]
        return (-0.5 * N * Dout * LOG2PI - Dout * logdet
                - 0.5 * torch.sum(torch.square(alpha), dim=(-2, -1)))

    def draw_samples_impl(self, rv_shape, num_samples, generator, X,
                          **inputs):
        K = _add_jitter(self.kernel.K(X, **self._kernel_args(inputs)),
                        self.jitter)
        L = torch.linalg.cholesky(K)
        eps = self._rand_gen.sample_normal(
            generator, shape=(num_samples,) + rv_shape, dtype=self.dtype)
        out = p_einsum("...ij,...jk->...ik", L, eps)
        if self.has_mean:
            out = out + inputs["mean"]
        return out

    # ------------------------------------------------------------------
    def _generate_outputs(self, shape):
        if shape is None:
            raise ValueError("GaussianProcess requires an explicit shape.")
        self.set_outputs([Variable(shape=shape)])

    @classmethod
    def define_variable(cls, X, kernel, shape=None, mean=None, rand_gen=None,
                        dtype=None, jitter=0.0):
        gp = cls(X=X, kernel=kernel, mean=mean, rand_gen=rand_gen,
                 dtype=dtype, jitter=jitter)
        gp._generate_outputs(shape=shape)
        return gp.random_variable

    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        replica.kernel = self.kernel.replicate_self(attribute_map)
        replica.has_mean = self.has_mean
        replica.jitter = self.jitter
        return replica
