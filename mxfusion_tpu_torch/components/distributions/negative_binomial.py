"""Negative-binomial distribution (overdispersed counts).

Counterpart of ``mxfusion_tpu/components/distributions/
negative_binomial.py``. Mean/dispersion parameterization: ``mean`` mu
and ``dispersion`` alpha, with ``Var[y] = mu + alpha mu²``. A draw is
the Gamma-Poisson mixture ``rate ~ Gamma(1/alpha, scale = alpha mu)``,
``y ~ Poisson(rate)``.
"""
import torch

from .distribution import UnivariateDistribution


def nb_log_pmf(y, log_mu, alpha):
    """Elementwise log NB(y | exp(log_mu), alpha), the single home of the
    NB algebra (the SVGP count module calls it with its latent f as
    ``log_mu``). With r = 1/alpha:
    lgamma(y+r) − lgamma(r) − lgamma(y+1) + r log r − (y+r) log(r+mu)
    + y log_mu, where log(r + mu) is ``logaddexp(log r, log_mu)``, so
    that exp(f) never overflows in float32 (f > 88 at Gauss-Hermite tail
    nodes)."""
    r = 1.0 / alpha
    log_r = torch.log(r)
    return (torch.lgamma(y + r) - torch.lgamma(r) - torch.lgamma(y + 1.0)
            + r * log_r - (y + r) * torch.logaddexp(log_r, log_mu)
            + y * log_mu)


class NegativeBinomial(UnivariateDistribution):
    """Counts with ``E[y] = mean``, ``Var[y] = mean + dispersion ·
    mean²``. Its support is the "real" default, as the JAX package's:
    counts are discrete, which no bijector targets."""

    def __init__(self, mean, dispersion, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("mean", mean), ("dispersion", dispersion)],
            outputs=None, input_names=["mean", "dispersion"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, mean, dispersion):
        return nb_log_pmf(random_variable, torch.log(mean), dispersion)

    def draw_samples_impl(self, rv_shape, num_samples, generator, mean,
                          dispersion):
        shape = (num_samples,) + rv_shape
        r = 1.0 / dispersion
        # Gamma-Poisson mixture: rate ~ Gamma(r, scale = mean / r)
        g = self._rand_gen.sample_gamma(
            generator, alpha=torch.broadcast_to(r, shape), beta=1.0,
            shape=shape, dtype=self.dtype)
        rate = g * mean / r
        return self._rand_gen.sample_poisson(
            generator, rate=rate, shape=shape, dtype=self.dtype)

    @classmethod
    def define_variable(cls, mean=1., dispersion=1., shape=None,
                        rand_gen=None, dtype=None):
        dist = cls(mean=mean, dispersion=dispersion, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
