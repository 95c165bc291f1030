"""Natural-gradient SVGP training.

The PyTorch port of ``examples/svgp_natural_gradient.py``: natural
gradient steps on q(U) (``NaturalGradientLoop``) and Adam on the
hyperparameters, on one evaluation of the SVGP bound a step.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.inference import (GradBasedInference, MAP,
                                          NaturalGradientLoop)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N, M = (200, 12) if SMOKE else (2000, 64)
MAX_ITER = 15 if SMOKE else 200
# at full size the 64 inducing points sit 0.06 apart at lengthscale 0.5,
# and Kuu is singular in float32 without jitter (the JAX script's loss is
# NaN there); at smoke size the model is the JAX script's
JITTER = 0.0 if SMOKE else 1e-4


def main():
    rng = np.random.default_rng(0)
    X = rng.random((N, 1)) * 4
    Y = np.sin(X * 2) + rng.standard_normal((N, 1)) * 0.1
    Z0 = np.linspace(0.1, 3.9, M)[:, None]

    m = Model()
    m.N = Variable()
    m.X = Variable(shape=(m.N, 1))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    kernel = RBF(input_dim=1, variance=1.0, lengthscale=0.5)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=kernel, noise_var=m.noise_var, shape=(m.N, 1),
        inducing_inputs=Variable(shape=(M, 1), initial_value=Z0),
        jitter=JITTER)

    alg = MAP(model=m, observed=[m.X, m.Y])
    loop = NaturalGradientLoop(module=m.Y.factor,
                               nat_learning_rate=0.5,
                               steps_per_call=1 if SMOKE else 10)
    infr = GradBasedInference(inference_algorithm=alg, grad_loop=loop)
    losses = []
    infr.run(max_iter=MAX_ITER, learning_rate=0.05, X=X, Y=Y,
             callback=lambda i, l: losses.append(float(l)))
    print("loss: {:.1f} -> {:.1f} in {} steps (NGD on q(U) + Adam on "
          "hyperparameters)".format(losses[0], losses[-1], len(losses)))
    noise = infr.params[m.noise_var].item()
    print("learned noise variance: {:.4f}".format(noise))
    return losses[-1]


if __name__ == "__main__":
    main()
