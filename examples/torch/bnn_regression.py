"""Bayesian neural-network regression.

The PyTorch port of ``examples/bnn_regression.py``: a ``torch.nn`` MLP
(Linear → tanh → Linear) lifted into the model by ``NNFunction``, Normal
priors over all its weights, a mean-field posterior trained by SVI, and
predictions by sampling the weights' posterior.
"""
import os

import numpy as np
import torch
from torch import nn

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions import NNFunction
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference,
    create_Gaussian_meanfield, VariationalPosteriorForwardSampling)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 80
MAX_ITER = 50 if SMOKE else 800


def main():
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(-3, 3, (N, 1)), axis=0)
    Y = np.sin(X) + rng.standard_normal((N, 1)) * 0.1

    torch.manual_seed(0)
    net = NNFunction(nn.Sequential(nn.Linear(1, 16), nn.Tanh(),
                                   nn.Linear(16, 1)),
                     name="f", input_shapes=[(N, 1)])
    m = Model()
    m.x = Variable(shape=(N, 1))
    m.r = net(m.x)
    for v in net.parameters.values():
        v.set_prior(Normal(mean=broadcast_to(Variable(value=0.), v.shape),
                           variance=broadcast_to(Variable(value=1.),
                                                 v.shape)))
    m.noise = Variable(transformation=PositiveTransformation(),
                       initial_value=0.01)
    m.y = Normal.define_variable(mean=m.r,
                                 variance=broadcast_to(m.noise, (N, 1)),
                                 shape=(N, 1))

    q = create_Gaussian_meanfield(model=m, observed=[m.x, m.y])
    alg = StochasticVariationalInference(num_samples=5, model=m,
                                         posterior=q,
                                         observed=[m.x, m.y])
    infr = GradBasedInference(inference_algorithm=alg)
    losses = []
    infr.run(max_iter=MAX_ITER, learning_rate=0.02, x=X, y=Y,
             callback=lambda i, l: losses.append(float(l)))
    print("loss: {:.1f} -> {:.1f}".format(losses[0], losses[-1]))

    fwd = VariationalPosteriorForwardSampling(
        num_samples=100, observed=[m.x], inherited_inference=infr,
        target_variables=[m.y])
    (samples,) = fwd.run(x=X)
    pred_mean = samples.mean(0).cpu().numpy()
    err = float(np.abs(pred_mean - np.sin(X)).mean())
    print("posterior predictive mean abs error vs sin(x): {:.3f}".format(
        err))
    return err


if __name__ == "__main__":
    main()
