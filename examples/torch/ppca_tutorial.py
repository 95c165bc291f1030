"""Probabilistic PCA by stochastic variational inference.

The PyTorch port of ``examples/ppca_tutorial.py``: a latent ``dot``
factor maps K = 2 latent dimensions onto D = 5 observed ones; a
mean-field posterior over the latents and a point estimate of the
loading matrix are trained by SVI, and the data are reconstructed
through them.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions.operators import (broadcast_to,
                                                               dot)
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference,
    create_Gaussian_meanfield)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N, K, D = 100, 2, 5
MAX_ITER = 50 if SMOKE else 1500


def main():
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((K, D))
    z_true = rng.standard_normal((N, K))
    x = z_true @ w_true + rng.standard_normal((N, D)) * 0.1

    m = Model()
    m.w = Variable(shape=(K, D),
                   initial_value=rng.standard_normal((K, D)) * 0.1)
    m.z = Normal.define_variable(
        mean=broadcast_to(Variable(value=0.), (N, K)),
        variance=broadcast_to(Variable(value=1.), (N, K)),
        shape=(N, K))
    m.x_mean = dot(m.z, m.w)
    m.noise = Variable(transformation=PositiveTransformation(),
                       initial_value=0.1)
    m.x = Normal.define_variable(mean=m.x_mean,
                                 variance=broadcast_to(m.noise, (N, D)),
                                 shape=(N, D))

    q = create_Gaussian_meanfield(model=m, observed=[m.x])
    alg = StochasticVariationalInference(num_samples=5, model=m,
                                         posterior=q, observed=[m.x])
    infr = GradBasedInference(inference_algorithm=alg)
    losses = []
    infr.run(max_iter=MAX_ITER, learning_rate=0.05, x=x,
             callback=lambda i, l: losses.append(float(l)))

    # reconstruction through the learned loading matrix
    z_post = infr.params[q.z.factor.mean].detach().cpu().numpy()
    w_post = infr.params[m.w].detach().cpu().numpy()
    recon = z_post.reshape(N, K) @ w_post.reshape(K, D)
    err = float(np.abs(recon - x).mean())
    print("loss: {:.1f} -> {:.1f}".format(losses[0], losses[-1]))
    print("mean reconstruction error: {:.3f}".format(err))
    return err


if __name__ == "__main__":
    main()
