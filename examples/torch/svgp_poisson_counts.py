"""GP regression of counts with a Poisson likelihood.

The PyTorch port of ``examples/svgp_poisson_counts.py``:
``SVGPPoissonRegression`` (log link, Gauss-Hermite bound) recovers a
smooth rate from Poisson counts.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import SVGPPoissonRegression
from mxfusion_tpu_torch.inference import (
    GradBasedInference, MAP, ModulePredictionAlgorithm, TransferInference)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 80 if SMOKE else 400
MAX_ITER = 40 if SMOKE else 800
M_INDUCING = 12


def main():
    rng = np.random.default_rng(0)
    X = np.sort(rng.random((N, 1)) * 4, 0)
    true_rate = np.exp(np.sin(X[:, 0]) + 0.5)
    Y = rng.poisson(true_rate)[:, None].astype(np.float64)

    m = Model()
    m.N = Variable()
    m.X = Variable(shape=(m.N, 1))
    m.Y = SVGPPoissonRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=1, variance=1.0, lengthscale=1.0),
        shape=(m.N, 1),
        inducing_inputs=Variable(
            shape=(M_INDUCING, 1),
            initial_value=np.linspace(0.1, 3.9, M_INDUCING)[:, None]))

    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]))
    infr.run(X=X, Y=Y, max_iter=MAX_ITER, learning_rate=0.05,
             verbose=not SMOKE)

    pred = TransferInference(ModulePredictionAlgorithm(
        model=m, observed=[m.X], target_variables=[m.Y.uuid]),
        infr_params=infr.params)
    mean, var = pred.run(X=X)[0]
    mean = mean[0, :, 0].cpu().numpy()
    var = var[0, :, 0].cpu().numpy()
    rel = float(np.median(np.abs(mean - true_rate) / true_rate))
    print("median relative rate error: {:.3f}".format(rel))
    print("count variance/mean (overdispersion from rate "
          "uncertainty): {:.3f}".format(float(np.mean(var / mean))))
    return rel


if __name__ == "__main__":
    main()
