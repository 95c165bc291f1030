"""Bayesian neural-network classification.

The PyTorch port of ``examples/bnn_classification.py``: a ``torch.nn``
MLP's logits feed a ``Categorical`` likelihood on two moons; Normal
priors over every weight and a mean-field posterior trained by SVI; the
network evaluated at the posterior-mean weights classifies the training
points.
"""
import os

import numpy as np
import torch
from torch import nn

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions import Categorical, Normal
from mxfusion_tpu_torch.components.functions import NNFunction
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference,
    create_Gaussian_meanfield)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 100
MAX_ITER = 50 if SMOKE else 600


def make_moons(n, rng):
    t = rng.uniform(0, np.pi, n)
    upper = np.stack([np.cos(t), np.sin(t)], -1)
    lower = np.stack([1 - np.cos(t), -np.sin(t) + 0.5], -1)
    X = np.concatenate([upper, lower]) + rng.standard_normal(
        (2 * n, 2)) * 0.1
    y = np.concatenate([np.zeros(n), np.ones(n)])[:, None]
    return X.astype(np.float64), y


def main():
    rng = np.random.default_rng(0)
    X, Y = make_moons(N // 2, rng)
    n = len(X)

    torch.manual_seed(0)
    net = NNFunction(nn.Sequential(nn.Linear(2, 16), nn.Tanh(),
                                   nn.Linear(16, 2)),
                     name="f", input_shapes=[(n, 2)])
    m = Model()
    m.x = Variable(shape=(n, 2))
    m.r = net(m.x)
    for v in net.parameters.values():
        v.set_prior(Normal(mean=broadcast_to(Variable(value=0.), v.shape),
                           variance=broadcast_to(Variable(value=1.),
                                                 v.shape)))
    m.y = Categorical.define_variable(log_prob=m.r, num_classes=2,
                                      shape=(n, 1))

    q = create_Gaussian_meanfield(model=m, observed=[m.x, m.y])
    alg = StochasticVariationalInference(num_samples=5, model=m,
                                         posterior=q,
                                         observed=[m.x, m.y])
    infr = GradBasedInference(inference_algorithm=alg)
    losses = []
    infr.run(max_iter=MAX_ITER, learning_rate=0.02, x=X, y=Y,
             callback=lambda i, l: losses.append(float(l)))
    print("loss: {:.1f} -> {:.1f}".format(losses[0], losses[-1]))

    # the network at the posterior-mean weights
    means = {name: infr.params[q[v].factor.mean].detach().reshape(v.shape)
             for name, v in net.parameters.items()}
    device = next(iter(means.values())).device
    with torch.no_grad():
        logits = net.eval(means, f_input_0=torch.as_tensor(
            X, dtype=torch.float32, device=device))
    acc = float((logits.argmax(-1).cpu().numpy() == Y[:, 0]).mean())
    print("train accuracy with posterior-mean weights: {:.3f}".format(acc))
    return acc


if __name__ == "__main__":
    main()
