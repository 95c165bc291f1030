"""Random generation facade.

Counterpart of ``mxfusion_tpu/components/distributions/random_gen.py``.
The JAX package threads explicit ``jax.random`` keys; here every method
takes an explicit ``torch.Generator`` as its first argument, and draws
on the generator's device. :class:`FixedRandomGenerator` is the test
double: it returns pre-seeded values reshaped on demand, ignoring the
generator, so a test can feed both packages the same draws.

The normal, gamma, multinomial, Bernoulli, uniform and exponential
draws are here; the Laplace, Poisson and Student-t draws come with
their distributions.
"""
import numpy as np
import torch

from ...common.config import as_torch_dtype


def _device(generator):
    return generator.device if generator is not None else None


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
        g = torch._standard_gamma(torch.broadcast_to(alpha, shape),
                                  generator=generator)
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
        return torch.as_tensor(out, dtype=as_torch_dtype(dtype),
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


_DEFAULT_RAND_GEN = RandomGenerator()


def default_rand_gen():
    return _DEFAULT_RAND_GEN
