"""Getting started: posterior inference on a toy Gaussian model.

The PyTorch port of ``examples/getting_started.py``: estimate the mean
and variance of noisy observations with a mean-field variational
posterior trained by reparameterized SVI, then draw from the posterior
predictive. Runs on the card unless the CPU is asked for
(``mxfusion_tpu_torch.common.config.set_default_device("cpu")``).
"""
import os

import numpy as np
import torch

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference,
    create_Gaussian_meanfield, VariationalPosteriorForwardSampling)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 100
MAX_ITER = 50 if SMOKE else 500


def main():
    rng = np.random.default_rng(0)
    y = rng.standard_normal((N, 1)) * 2.0 + 3.0

    m = Model()
    m.mu = Normal.define_variable(mean=0., variance=100., shape=(1,))
    m.s = Variable(transformation=PositiveTransformation(),
                   initial_value=5.)
    m.y = Normal.define_variable(mean=broadcast_to(m.mu, (N, 1)),
                                 variance=broadcast_to(m.s, (N, 1)),
                                 shape=(N, 1))

    q = create_Gaussian_meanfield(model=m, observed=[m.y])
    alg = StochasticVariationalInference(num_samples=10, model=m,
                                         posterior=q, observed=[m.y])
    infr = GradBasedInference(inference_algorithm=alg)
    infr.run(max_iter=MAX_ITER, learning_rate=0.1, y=y, verbose=not SMOKE)

    mu_post = infr.params[q.mu.factor.mean].flatten()[0].item()
    s_post = infr.params[m.s].flatten()[0].item()
    print("posterior mean: {:.3f} (data mean {:.3f})".format(mu_post,
                                                             y.mean()))
    print("noise variance: {:.3f} (data var {:.3f})".format(s_post,
                                                            y.var()))

    # posterior predictive samples
    fwd = VariationalPosteriorForwardSampling(
        num_samples=200, observed=[], inherited_inference=infr,
        target_variables=[m.y])
    (samples,) = fwd.run(generator=torch.Generator(
        infr.params.device).manual_seed(1))
    print("predictive sample mean: {:.3f}".format(samples.mean().item()))
    return mu_post, s_post


if __name__ == "__main__":
    main()
