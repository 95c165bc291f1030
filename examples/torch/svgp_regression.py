"""Stochastic variational GP regression with minibatches.

The PyTorch port of ``examples/svgp_regression.py``: ``SVGPRegression``
with trainable inducing points, fitted by MAP over minibatches of the
host loop (the native batcher's shuffle, N/B rescaling), then
predictive moments at test inputs. On the card K1 builds the grams.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.inference import (
    GradBasedInference, MAP, MinibatchInferenceLoop,
    ModulePredictionAlgorithm, TransferInference)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 200 if SMOKE else 2000
BATCH = 100
EPOCHS = 5 if SMOKE else 60
M_INDUCING = 20


def main():
    rng = np.random.default_rng(0)
    X = rng.random((N, 1)) * 4
    Y = np.sin(X) + rng.standard_normal((N, 1)) * 0.1

    m = Model()
    m.N = Variable()
    m.X = Variable(shape=(m.N, 1))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    Z0 = np.linspace(0, 4, M_INDUCING)[:, None]
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=1, variance=1., lengthscale=1.),
        noise_var=m.noise_var, shape=(m.N, 1),
        inducing_inputs=Variable(shape=(M_INDUCING, 1),
                                 initial_value=Z0))

    loop = MinibatchInferenceLoop(batch_size=BATCH,
                                  rv_scaling={m.Y: N / BATCH})
    infr = GradBasedInference(
        inference_algorithm=MAP(model=m, observed=[m.X, m.Y]),
        grad_loop=loop)
    infr.run(max_iter=EPOCHS, learning_rate=0.05, X=X, Y=Y,
             verbose=not SMOKE)

    Xt = np.linspace(0, 4, 20)[:, None]
    pred = TransferInference(ModulePredictionAlgorithm(
        model=m, observed=[m.X], target_variables=[m.Y.uuid]),
        infr_params=infr.params)
    mu, var = pred.run(X=Xt)[0]
    err = float(np.abs(mu[0].cpu().numpy() - np.sin(Xt)).mean())
    print("predictive mean abs error vs sin(x): {:.4f}".format(err))
    return err


if __name__ == "__main__":
    main()
