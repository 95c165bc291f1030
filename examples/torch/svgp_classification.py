"""GP binary classification with a stochastic variational GP.

The PyTorch port of ``examples/svgp_classification.py``:
``SVGPClassification`` on two moons (a Gauss-Hermite bound, whitened
q(U), trainable inducing points); prediction returns calibrated class
probabilities.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import SVGPClassification
from mxfusion_tpu_torch.inference import (GradBasedInference, MAP,
                                          ModulePredictionAlgorithm,
                                          TransferInference)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 150 if SMOKE else 600
MAX_ITER = 40 if SMOKE else 800


def two_moons(n, rng):
    t = rng.random(n) * np.pi
    upper = rng.random(n) > 0.5
    x = np.where(upper, np.cos(t), 1.0 - np.cos(t))
    z = np.where(upper, np.sin(t) - 0.5, -np.sin(t))
    X = np.stack([x, z], axis=-1) + rng.standard_normal((n, 2)) * 0.15
    return X, upper.astype(np.float64)[:, None]


def main():
    rng = np.random.default_rng(0)
    X, y = two_moons(N, rng)
    Z0 = X[rng.choice(N, 16, replace=False)]

    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, 2))
    m.Y = SVGPClassification.define_variable(
        X=m.X, kernel=RBF(input_dim=2, variance=2.0, lengthscale=0.5),
        shape=(m.n, 1),
        inducing_inputs=Variable(shape=Z0.shape, initial_value=Z0),
        whitened=True)

    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]))
    loss = float(infr.run(X=X, Y=y, max_iter=MAX_ITER, learning_rate=0.03,
                          verbose=False))

    Xt, yt = two_moons(200, rng)
    pred = TransferInference(ModulePredictionAlgorithm(
        model=m, observed=[m.X], target_variables=[m.Y.uuid]),
        infr_params=infr.params)
    p, _ = pred.run(X=Xt)[0]
    p = p[0, :, 0].cpu().numpy()
    acc = float(((p > 0.5) == (yt[:, 0] > 0.5)).mean())
    print("final -ELBO: {:.2f}".format(loss))
    print("held-out accuracy: {:.3f}".format(acc))
    return acc


if __name__ == "__main__":
    main()
