"""The implicit reparameterization gradient of a gamma draw.

``random_gamma_grad(a, x)`` is dx/da of a Gamma(a, 1) draw x with its
uniform held fixed: ``-(∂F/∂a) / p(x)`` for the gamma CDF F. It is a
port of ``jax.lax.random_gamma_grad`` (``random_gamma_grad_impl`` in
JAX's ``_src/lax/special.py``): the power series of the lower
incomplete gamma function where ``x <= 1 or x <= a``, else the
continued fraction of the upper one, both differentiated in ``a`` along
the loop, with JAX's stopping rules, iteration cap and masks for x = 0,
the domain error and underflow.

JAX runs each loop under a mask until no lane is enabled. Here each
iteration is a few elementwise kernels, and the host reads whether any
lane is still enabled every ``CHECK_EVERY`` iterations: a lane that
has stopped is not updated again, so the result is the one JAX's loop
gives. ``random_gamma_grad.iterations`` holds the number of iterations
the last call ran in each loop.
"""
import math

import torch

CHECK_EVERY = 8
# the continued fraction's cap, JAX's
MAX_FRACTION_ITERATIONS = 2000


def _series(x, a, enabled):
    """``_igamma_series`` in ``SAMPLE_DERIVATIVE`` mode."""
    eps = torch.finfo(a.dtype).eps
    r = a.clone()
    c = torch.ones_like(a)
    ans = torch.ones_like(a)
    dc_da = torch.zeros_like(a)
    dans_da = torch.zeros_like(a)
    n = 0
    while bool(enabled.any()):
        for _ in range(CHECK_EVERY):
            r_n = r + 1.0
            dc_da_n = dc_da * (x / r_n) - (c * x) / (r_n * r_n)
            dans_da_n = dans_da + dc_da_n
            c_n = c * (x / r_n)
            ans_n = ans + c_n
            go = enabled & (torch.abs(dc_da_n / dans_da_n) > eps)
            r = torch.where(enabled, r_n, r)
            c = torch.where(enabled, c_n, c)
            ans = torch.where(enabled, ans_n, ans)
            dc_da = torch.where(enabled, dc_da_n, dc_da)
            dans_da = torch.where(enabled, dans_da_n, dans_da)
            enabled = go
        n += CHECK_EVERY
    dlogax_da = torch.log(x) - torch.digamma(a + 1.0)
    return -(dans_da + ans * dlogax_da) * x / a, n


def _continued_fraction(x, a, enabled):
    """``_igammac_continued_fraction`` in ``SAMPLE_DERIVATIVE`` mode."""
    eps = torch.finfo(a.dtype).eps
    y = 1.0 - a
    z = x + y + 1.0
    pkm2 = torch.ones_like(x)
    qkm2 = x
    pkm1 = x + 1.0
    qkm1 = z * x
    ans = pkm1 / qkm1
    dpkm2_da = torch.zeros_like(x)
    dqkm2_da = torch.zeros_like(x)
    dpkm1_da = torch.zeros_like(x)
    dqkm1_da = -x
    dans_da = (dpkm1_da - ans * dqkm1_da) / qkm1
    one = torch.ones_like(x)
    c = 0
    while c < MAX_FRACTION_ITERATIONS and bool(enabled.any()):
        for _ in range(min(CHECK_EVERY, MAX_FRACTION_ITERATIONS - c)):
            c += 1
            y_n = y + 1.0
            z_n = z + 2.0
            yc = y_n * c
            pk = pkm1 * z_n - pkm2 * yc
            qk = qkm1 * z_n - qkm2 * yc
            nonzero = qk != 0
            r = pk / qk
            ans_n = torch.where(nonzero, r, ans)
            dpk_da = dpkm1_da * z_n - pkm1 - dpkm2_da * yc + pkm2 * c
            dqk_da = dqkm1_da * z_n - qkm1 - dqkm2_da * yc + qkm2 * c
            dans_da_n = torch.where(nonzero, (dpk_da - ans_n * dqk_da) / qk,
                                    dans_da)
            grad_cond = torch.where(nonzero, torch.abs(dans_da_n - dans_da),
                                    one)
            pkm2_n, pkm1_n, qkm2_n, qkm1_n = pkm1, pk, qkm1, qk
            dpkm2_n, dqkm2_n, dpkm1_n, dqkm1_n = (dpkm1_da, dqkm1_da, dpk_da,
                                                  dqk_da)
            rescale = torch.abs(pk) > 1.0 / eps
            pkm2_n, pkm1_n, qkm2_n, qkm1_n, dpkm2_n, dqkm2_n, dpkm1_n, \
                dqkm1_n = (torch.where(rescale, v * eps, v) for v in (
                    pkm2_n, pkm1_n, qkm2_n, qkm1_n, dpkm2_n, dqkm2_n,
                    dpkm1_n, dqkm1_n))
            go = enabled & (grad_cond > eps)
            ans = torch.where(enabled, ans_n, ans)
            y = torch.where(enabled, y_n, y)
            z = torch.where(enabled, z_n, z)
            pkm1 = torch.where(enabled, pkm1_n, pkm1)
            qkm1 = torch.where(enabled, qkm1_n, qkm1)
            pkm2 = torch.where(enabled, pkm2_n, pkm2)
            qkm2 = torch.where(enabled, qkm2_n, qkm2)
            dpkm2_da = torch.where(enabled, dpkm2_n, dpkm2_da)
            dqkm2_da = torch.where(enabled, dqkm2_n, dqkm2_da)
            dpkm1_da = torch.where(enabled, dpkm1_n, dpkm1_da)
            dqkm1_da = torch.where(enabled, dqkm1_n, dqkm1_da)
            dans_da = torch.where(enabled, dans_da_n, dans_da)
            enabled = go
    dlogax_da = torch.log(x) - torch.digamma(a)
    return -(dans_da + ans * dlogax_da) * x, c


@torch.no_grad()
def random_gamma_grad(a, x):
    """dx/da of the Gamma(a, 1) draw ``x`` (elementwise, ``a`` and ``x``
    broadcast), as ``jax.lax.random_gamma_grad``."""
    a, x = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(x))
    is_nan = torch.isnan(a) | torch.isnan(x)
    # a subnormal x counts as 0, as under the flush-to-zero of XLA's CPU
    # and GPU backends
    x_is_zero = torch.abs(x) < torch.finfo(x.dtype).tiny
    x = torch.where(x_is_zero, torch.zeros_like(x), x)
    domain_error = (x < 0) | (a <= 0)
    use_fraction = (x > 1) & (x > a)
    ax = a * torch.log(x) - x - torch.lgamma(a)
    underflow = ax < -math.log(torch.finfo(a.dtype).max)
    enabled = ~(x_is_zero | domain_error | underflow | is_nan)
    frac, n_frac = _continued_fraction(x, a, enabled & use_fraction)
    series, n_series = _series(x, a, enabled & ~use_fraction)
    random_gamma_grad.iterations = {"series": n_series, "fraction": n_frac}
    out = torch.where(use_fraction, -frac, series)
    out = torch.where(x_is_zero, torch.zeros_like(out), out)
    return torch.where(domain_error | is_nan,
                       torch.full_like(out, float("nan")), out)


random_gamma_grad.iterations = {"series": 0, "fraction": 0}
