"""Random generation facade.

Counterpart of ``mxfusion_tpu/components/distributions/random_gen.py``.
The JAX package threads explicit ``jax.random`` keys; here every method
takes an explicit ``torch.Generator`` as its first argument, and draws
on the generator's device. :class:`FixedRandomGenerator` is the test
double: it returns pre-seeded values reshaped on demand, ignoring the
generator, so a test can feed both packages the same draws.

So far the normal draw, the one the ported distributions use.
"""
import numpy as np
import torch

from ...common.config import as_torch_dtype


class RandomGenerator:
    """Generator-threaded sampling facade over ``torch``."""

    def sample_normal(self, generator, loc=0.0, scale=1.0, shape=None,
                      dtype=None):
        eps = torch.randn(shape, generator=generator,
                          dtype=as_torch_dtype(dtype),
                          device=generator.device)
        return loc + scale * eps


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
        device = generator.device if generator is not None else None
        return loc + scale * self._next(shape, dtype, device)


_DEFAULT_RAND_GEN = RandomGenerator()


def default_rand_gen():
    return _DEFAULT_RAND_GEN
