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

Every draw of :class:`RandomGenerator` takes its randomness from
:func:`base_draw`: a draw with a parameter-free base (a standard
normal, a standard uniform, a unit exponential) transforms that base in
torch, and a gamma or Poisson draw takes one key (kind ``"key"``, two
int64 words below 2³²) and draws as ``jax.random`` does, a pure function
of key, parameter and element index (``ops/keyed_random.py``: R1 and
R2, one kernel each on the card). Under :func:`drawing_from` the base
draws are recorded or replayed instead: ``BatchedPredictor.export``
records a chunk's base draws, traces them as inputs of the program, and
the artifact makes the same calls on the caller's generator at each
chunk, so its stream advances as the live predictor's does and it draws
the live predictor's numbers. The source is the calling thread's, so a
predictor serving in another thread of the process draws from its own
generator meanwhile.
"""
import threading
from contextlib import contextmanager

import numpy as np
import torch

from ...common.config import as_torch_dtype
from ...ops.igamma import random_gamma_grad
from ...ops.keyed_random import keyed_poisson, keyed_standard_gamma


def _device(generator):
    return generator.device if generator is not None else None


_BASE_DRAWS = {
    "normal": lambda g, shape, dtype: torch.randn(
        shape, generator=g, dtype=dtype, device=g.device),
    "uniform": lambda g, shape, dtype: torch.rand(
        shape, generator=g, dtype=dtype, device=g.device),
    "exponential": lambda g, shape, dtype: torch.empty(
        shape, dtype=dtype, device=g.device).exponential_(generator=g),
    "key": lambda g, shape, dtype: torch.randint(
        0, 2 ** 32, shape, generator=g, dtype=torch.int64, device=g.device),
}

class _Source(threading.local):
    source = None   # this thread's active DrawRecorder or DrawReplay


_SOURCE = _Source()


def base_draw(kind, generator, shape, dtype=None):
    """A parameter-free draw of ``kind`` ("normal", "uniform",
    "exponential", "key") on ``generator``, or, under
    :func:`drawing_from`, the source's."""
    dtype = as_torch_dtype(dtype)
    if _SOURCE.source is not None:
        return _SOURCE.source.draw(kind, generator, tuple(shape), dtype)
    return _BASE_DRAWS[kind](generator, shape, dtype)


def draw_key(generator):
    """One key of the keyed draws: int64 (2,), each word below 2³²."""
    return base_draw("key", generator, (2,), torch.int64)


@contextmanager
def drawing_from(source):
    """Take every base draw from ``source`` (a :class:`DrawRecorder` or
    a :class:`DrawReplay`) inside the block, in this thread."""
    old, _SOURCE.source = _SOURCE.source, source
    try:
        yield source
    finally:
        _SOURCE.source = old


class DrawRecorder:
    """Draws as usual and records each base draw's kind, shape and
    dtype, in order (``specs``), with the values drawn (``values``)."""

    def __init__(self):
        self.specs, self.values = [], []

    def draw(self, kind, generator, shape, dtype):
        x = _BASE_DRAWS[kind](generator, shape, dtype)
        self.specs.append((kind, shape, x.dtype))
        self.values.append(x)
        return x


class DrawReplay:
    """Returns ``values`` in order, each checked against the draw it
    stands for."""

    def __init__(self, values):
        self._values = list(values)
        self._next = 0

    def draw(self, kind, generator, shape, dtype):
        if self._next == len(self._values):
            raise RuntimeError("more base draws than were recorded")
        x = self._values[self._next]
        self._next += 1
        if tuple(x.shape) != shape:
            raise RuntimeError("a {} draw of shape {} replayed as {}".format(
                kind, shape, tuple(x.shape)))
        return x


def draw_inputs(specs, generator):
    """The base draws of ``specs`` on ``generator``, in order: the calls
    that the live path makes."""
    return [_BASE_DRAWS[kind](generator, shape, dtype)
            for kind, shape, dtype in specs]


class _StandardGamma(torch.autograd.Function):
    """Gamma(alpha, 1) draws under ``key`` (R1); the backward in
    ``alpha`` is JAX's implicit gradient, ``random_gamma_grad(alpha, x)``."""

    @staticmethod
    def forward(ctx, alpha, key):
        x = keyed_standard_gamma(alpha, key)
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
        return loc + scale * base_draw("normal", generator, shape, dtype)

    def sample_gamma(self, generator, alpha=1.0, beta=1.0, shape=None,
                     dtype=None):
        """Gamma(shape=alpha, rate=beta) samples. The backward in
        ``alpha`` is the implicit reparameterization gradient, as
        ``jax.random.gamma``'s is. One key from ``generator``."""
        alpha = torch.as_tensor(alpha, dtype=as_torch_dtype(dtype),
                                device=generator.device)
        g = _StandardGamma.apply(torch.broadcast_to(alpha, shape),
                                 draw_key(generator))
        return g / beta

    def sample_multinomial(self, generator, data, shape=None,
                           get_prob=False, dtype=torch.int64):
        """Categorical indices from probabilities on the last axis, by
        Gumbel-argmax over ``log(data)`` (as ``jax.random.categorical``).
        int64 indices, which ``torch.gather`` takes."""
        u = base_draw("uniform", generator, data.shape, data.dtype)
        tiny = torch.finfo(data.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return torch.argmax(torch.log(data) + gumbel, dim=-1).to(dtype)

    def sample_bernoulli(self, generator, prob_true=0.5, shape=None,
                         dtype=None):
        """Boolean draws, as ``jax.random.bernoulli``'s."""
        p = torch.as_tensor(prob_true, device=generator.device)
        return base_draw("uniform", generator, shape, p.dtype) < p

    def sample_uniform(self, generator, low=0.0, high=1.0, shape=None,
                       dtype=None):
        u = base_draw("uniform", generator, shape, dtype)
        return low + u * (high - low)

    def sample_exponential(self, generator, rate=1.0, shape=None,
                           dtype=None):
        return base_draw("exponential", generator, shape, dtype) / rate

    def sample_laplace(self, generator, location=0.0, scale=1.0, shape=None,
                       dtype=None):
        """Inverse CDF from uniform(-0.5, 0.5), as the JAX package's."""
        u = base_draw("uniform", generator, shape, dtype) - 0.5
        return location - scale * torch.sign(u) * torch.log1p(
            -2.0 * torch.abs(u))

    def sample_poisson(self, generator, rate=1.0, shape=None, dtype=None):
        """Counts in ``dtype``, drawn in ``dtype`` where it is float32 or
        float64 and in float64 otherwise; no gradient flows into the
        rate. One key from ``generator``."""
        dtype = as_torch_dtype(dtype)
        work = dtype if dtype in (torch.float32, torch.float64) \
            else torch.float64
        lam = torch.broadcast_to(torch.as_tensor(
            rate, device=generator.device).detach().to(work), shape)
        return keyed_poisson(lam, draw_key(generator)).to(dtype)

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
