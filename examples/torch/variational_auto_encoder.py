"""A variational auto-encoder.

The PyTorch port of ``examples/variational_auto_encoder.py``: a
``torch.nn`` decoder (``NNFunction``) maps the latents to the data's
mean in the model; an amortized ``torch.nn`` encoder with two heads
gives the posterior's mean and variance of each point's latent; both
networks are trained by reparameterized SVI.
"""
import os

import numpy as np
import torch
from torch import nn

from mxfusion_tpu_torch import Model, Posterior, Variable
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions import NNFunction
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N, D, K = 100, 8, 2
MAX_ITER = 40 if SMOKE else 1000


def lecun_normal_(module, seed):
    """Every ``nn.Linear`` of ``module`` to LeCun-normal weights (a
    normal of variance 1/fan_in truncated at two standard deviations)
    and zero biases, drawn from a ``torch.Generator`` seeded with
    ``seed``: the start flax's Dense layers take in the JAX example
    (``nn.Linear``'s default start trains this VAE several times
    slower)."""
    g = torch.Generator().manual_seed(seed)
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            # the truncation's variance loss restored, as flax does
            std = layer.in_features ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=g)
            nn.init.zeros_(layer.bias)
    return module


class Decoder(nn.Module):
    def __init__(self, latent, out, hidden=16):
        super().__init__()
        self.hidden = nn.Linear(latent, hidden)
        self.out = nn.Linear(hidden, out)

    def forward(self, z):
        return self.out(torch.tanh(self.hidden(z)))


class Encoder(nn.Module):
    """x -> (mean, variance) of q(z | x)."""

    def __init__(self, data, latent, hidden=16):
        super().__init__()
        self.hidden = nn.Linear(data, hidden)
        self.mean = nn.Linear(hidden, latent)
        self.log_var = nn.Linear(hidden, latent)

    def forward(self, x):
        h = torch.tanh(self.hidden(x))
        return self.mean(h), torch.exp(self.log_var(h)) + 1e-6


def main():
    rng = np.random.default_rng(0)
    z_true = rng.standard_normal((N, K))
    proj = rng.standard_normal((K, D))
    x = np.tanh(z_true @ proj) + rng.standard_normal((N, D)) * 0.05

    decoder = NNFunction(lecun_normal_(Decoder(K, D), seed=0), name="dec",
                         input_shapes=[(N, K)])
    m = Model()
    m.z = Normal.define_variable(
        mean=broadcast_to(Variable(value=0.), (N, K)),
        variance=broadcast_to(Variable(value=1.), (N, K)),
        shape=(N, K))
    m.x_mean = decoder(m.z)
    m.x = Normal.define_variable(
        mean=m.x_mean,
        variance=broadcast_to(Variable(value=0.01), (N, D)),
        shape=(N, D))

    encoder = NNFunction(lecun_normal_(Encoder(D, K), seed=1), name="enc",
                         input_shapes=[(N, D)], num_outputs=2)
    q = Posterior(m)
    q_mean, q_var = encoder(q.x)
    q.z.set_prior(Normal(mean=q_mean, variance=q_var))

    alg = StochasticVariationalInference(num_samples=3, model=m,
                                         posterior=q, observed=[m.x])
    infr = GradBasedInference(inference_algorithm=alg)
    losses = []
    infr.run(max_iter=MAX_ITER, learning_rate=0.01, x=x,
             callback=lambda i, l: losses.append(float(l)))
    print("ELBO loss: {:.1f} -> {:.1f}".format(losses[0], losses[-1]))
    assert losses[-1] < losses[0]
    return losses[-1]


if __name__ == "__main__":
    main()
