"""Random generation facade.

Counterpart of ``mxfusion_tpu/components/distributions/random_gen.py``.
The JAX package threads explicit ``jax.random`` keys; here every method
takes an explicit ``torch.Generator`` as its first argument, and draws
on the generator's device. :class:`FixedRandomGenerator` is the test
double: it returns pre-seeded values reshaped on demand, ignoring the
generator, so a test can feed both packages the same draws.

A gamma draw's gradient in its shape is the implicit reparameterization
gradient that ``jax.random.gamma`` has (``ops/igamma.py``); the
Student-t draw takes its chi-square from it.
"""
import numpy as np
import torch

from ...common.config import as_torch_dtype
from ...ops.igamma import random_gamma_grad


def _device(generator):
    return generator.device if generator is not None else None


class _StandardGamma(torch.autograd.Function):
    """Gamma(alpha, 1) draws on ``generator``; the backward in ``alpha``
    is JAX's implicit gradient, ``random_gamma_grad(alpha, x)``."""

    @staticmethod
    def forward(ctx, alpha, generator):
        x = torch._standard_gamma(alpha, generator=generator)
        ctx.save_for_backward(alpha, x)
        return x

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        alpha, x = ctx.saved_tensors
        return g * random_gamma_grad(alpha, x), None


class RandomGenerator:
    """Generator-threaded sampling facade over ``torch``."""

    def sample_normal(self, generator, loc=0.0, scale=1.0, shape=None,
                      dtype=None):
        eps = torch.randn(shape, generator=generator,
                          dtype=as_torch_dtype(dtype),
                          device=generator.device)
        return loc + scale * eps

    def sample_gamma(self, generator, alpha=1.0, beta=1.0, shape=None,
                     dtype=None):
        """Gamma(shape=alpha, rate=beta) samples. The backward in
        ``alpha`` is the implicit reparameterization gradient, as
        ``jax.random.gamma``'s is."""
        alpha = torch.as_tensor(alpha, dtype=as_torch_dtype(dtype),
                                device=generator.device)
        g = _StandardGamma.apply(torch.broadcast_to(alpha, shape), generator)
        return g / beta

    def sample_multinomial(self, generator, data, shape=None,
                           get_prob=False, dtype=torch.int64):
        """Categorical indices from probabilities on the last axis, by
        Gumbel-argmax over ``log(data)`` (as ``jax.random.categorical``).
        int64 indices, which ``torch.gather`` takes."""
        u = torch.rand(data.shape, generator=generator, dtype=data.dtype,
                       device=generator.device)
        tiny = torch.finfo(data.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return torch.argmax(torch.log(data) + gumbel, dim=-1).to(dtype)

    def sample_bernoulli(self, generator, prob_true=0.5, shape=None,
                         dtype=None):
        """Boolean draws, as ``jax.random.bernoulli``'s."""
        p = torch.as_tensor(prob_true, device=generator.device)
        u = torch.rand(shape, generator=generator, dtype=p.dtype,
                       device=generator.device)
        return u < p

    def sample_uniform(self, generator, low=0.0, high=1.0, shape=None,
                       dtype=None):
        u = torch.rand(shape, generator=generator,
                       dtype=as_torch_dtype(dtype), device=generator.device)
        return low + u * (high - low)

    def sample_exponential(self, generator, rate=1.0, shape=None,
                           dtype=None):
        e = torch.empty(shape, dtype=as_torch_dtype(dtype),
                        device=generator.device).exponential_(
                            generator=generator)
        return e / rate

    def sample_laplace(self, generator, location=0.0, scale=1.0, shape=None,
                       dtype=None):
        """Inverse CDF from uniform(-0.5, 0.5), as the JAX package's."""
        u = torch.rand(shape, generator=generator,
                       dtype=as_torch_dtype(dtype),
                       device=generator.device) - 0.5
        return location - scale * torch.sign(u) * torch.log1p(
            -2.0 * torch.abs(u))

    def sample_poisson(self, generator, rate=1.0, shape=None, dtype=None):
        """Counts in ``dtype``; no gradient flows into the rate."""
        lam = torch.broadcast_to(torch.as_tensor(
            rate, device=generator.device), shape).detach()
        return torch.poisson(lam, generator=generator).to(
            as_torch_dtype(dtype))

    def sample_studentt(self, generator, degrees_of_freedom, location=0.0,
                        scale=1.0, shape=None, dtype=None):
        """``normal · sqrt(ν / χ²_ν)``, as ``jax.random.t``: the χ² is
        twice a Gamma(ν/2) draw, so its gradient in ν is the implicit
        one."""
        half_df = torch.as_tensor(degrees_of_freedom,
                                  dtype=as_torch_dtype(dtype),
                                  device=generator.device) / 2.0
        n = self.sample_normal(generator, shape=shape, dtype=dtype)
        g = self.sample_gamma(generator, alpha=half_df, shape=shape,
                              dtype=dtype)
        return location + scale * n * torch.sqrt(half_df / g)


class FixedRandomGenerator(RandomGenerator):
    """Deterministic test double returning pre-seeded samples.

    Successive calls consume the sample buffer in order; each call
    reshapes the next ``prod(shape)`` values to the requested shape.
    """

    def __init__(self, samples):
        self._samples = np.ravel(np.asarray(samples))
        self._cursor = 0

    def reset(self):
        self._cursor = 0

    def _next(self, shape, dtype=None, device=None):
        n = int(np.prod(shape))
        out = self._samples[self._cursor:self._cursor + n].reshape(shape)
        self._cursor += n
        if self._cursor >= self._samples.shape[0]:
            self._cursor = 0
        # no dtype keeps the buffer's, as the JAX package's double does
        return torch.as_tensor(
            out, dtype=None if dtype is None else as_torch_dtype(dtype),
            device=device)

    def sample_normal(self, generator, loc=0.0, scale=1.0, shape=None,
                      dtype=None):
        return loc + scale * self._next(shape, dtype, _device(generator))

    def sample_gamma(self, generator, alpha=1.0, beta=1.0, shape=None,
                     dtype=None):
        return self._next(shape, dtype, _device(generator)) / beta

    def sample_multinomial(self, generator, data, shape=None,
                           get_prob=False, dtype=torch.int64):
        return self._next(tuple(data.shape[:-1]),
                          device=_device(generator)).to(dtype)

    def sample_bernoulli(self, generator, prob_true=0.5, shape=None,
                         dtype=None):
        return self._next(shape, device=_device(generator))

    def sample_uniform(self, generator, low=0.0, high=1.0, shape=None,
                       dtype=None):
        u = self._next(shape, dtype, _device(generator))
        return low + u * (high - low)

    def sample_exponential(self, generator, rate=1.0, shape=None,
                           dtype=None):
        return self._next(shape, dtype, _device(generator)) / rate

    def sample_laplace(self, generator, location=0.0, scale=1.0, shape=None,
                       dtype=None):
        return location + scale * self._next(shape, dtype,
                                             _device(generator))

    def sample_poisson(self, generator, rate=1.0, shape=None, dtype=None):
        return self._next(shape, dtype, _device(generator))

    def sample_studentt(self, generator, degrees_of_freedom, location=0.0,
                        scale=1.0, shape=None, dtype=None):
        return location + scale * self._next(shape, dtype,
                                             _device(generator))


_DEFAULT_RAND_GEN = RandomGenerator()


def default_rand_gen():
    return _DEFAULT_RAND_GEN
