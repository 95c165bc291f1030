"""Gaussian AR(1) process distribution over a latent path.

Counterpart of ``mxfusion_tpu/components/distributions/ar1.py``: the
prior of non-Gaussian state-space models (stochastic volatility, dynamic
factors), whose non-conjugate likelihood the samplers handle.

    x_0 ~ N(init_mean, init_var)
    x_t ~ N(phi * x_{t-1}, noise_var)        t = 1..T-1

The event's last axis is time. The density is elementwise, one
shifted-difference expression with no loop; sampling is a loop over
time (the recursion is serial), on draws of the distribution's
``rand_gen``.
"""
import torch

from .distribution import UnivariateDistribution

_LOG2PI = 1.8378770664093453


class GaussianAR1(UnivariateDistribution):
    """``x_t = phi x_{t-1} + sqrt(noise_var) eps_t`` with a Gaussian
    initial state. Parameters broadcast elementwise against the leading
    (non-time) event axes."""

    #: each step depends on the one before
    row_separable = False

    def __init__(self, phi, noise_var, init_mean=0.0, init_var=1.0,
                 rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("phi", phi), ("noise_var", noise_var),
                    ("init_mean", init_mean), ("init_var", init_var)],
            outputs=None,
            input_names=["phi", "noise_var", "init_mean", "init_var"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    @staticmethod
    def _check_time_constant(**params):
        # a (T,)-shaped parameter would broadcast the initial term across
        # the time axis (T spurious initial-state terms) and the sampler
        # would use only its t = 0 value: refuse it when called
        for name, p in params.items():
            if p.shape[-1] != 1:
                raise ValueError(
                    "GaussianAR1 parameters are time-constant; '{}' "
                    "has trailing (time-aligned) dim {} != 1. Reshape "
                    "it to broadcast over leading axes only.".format(
                        name, p.shape[-1]))

    def log_pdf_impl(self, random_variable, phi, noise_var, init_mean,
                     init_var):
        self._check_time_constant(phi=phi, noise_var=noise_var,
                                  init_mean=init_mean, init_var=init_var)
        x = random_variable                        # (..., T)
        x0 = x[..., :1]
        lp0 = -0.5 * (_LOG2PI + torch.log(init_var)
                      + torch.square(x0 - init_mean) / init_var)
        resid = x[..., 1:] - phi * x[..., :-1]
        lpt = -0.5 * (_LOG2PI + torch.log(noise_var)
                      + torch.square(resid) / noise_var)
        return torch.cat([lp0, lpt], dim=-1)

    def draw_samples_impl(self, rv_shape, num_samples, generator, phi,
                          noise_var, init_mean, init_var):
        self._check_time_constant(phi=phi, noise_var=noise_var,
                                  init_mean=init_mean, init_var=init_var)
        shape = (num_samples,) + tuple(rv_shape)   # (..., T)
        eps = self._rand_gen.sample_normal(generator, shape=shape,
                                           dtype=self.dtype)
        # the parameters are time-constant: collapse the (broadcast) time
        # axis to per-path scalars for the recursion
        phi0 = torch.broadcast_to(phi, shape)[..., 0]
        sd0 = torch.sqrt(torch.broadcast_to(noise_var, shape)[..., 0])
        m0 = torch.broadcast_to(init_mean, shape)[..., 0]
        v0 = torch.broadcast_to(init_var, shape)[..., 0]
        x = m0 + torch.sqrt(v0) * eps[..., 0]
        xs = [x]
        for t in range(1, shape[-1]):
            x = phi0 * x + sd0 * eps[..., t]
            xs.append(x)
        return torch.stack(xs, dim=-1)
