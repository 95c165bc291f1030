"""Multi-class GP classification.

The PyTorch port of ``examples/svgp_multiclass.py``:
``SVGPMultiClassification`` (a softmax link, a Monte Carlo expected
log-likelihood on the caller's generator) on three Gaussian clusters;
prediction returns MC-averaged class probabilities.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import SVGPMultiClassification
from mxfusion_tpu_torch.inference import (GradBasedInference, MAP,
                                          ModulePredictionAlgorithm,
                                          TransferInference)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 90 if SMOKE else 450
MAX_ITER = 40 if SMOKE else 600
C = 3


def main():
    rng = np.random.default_rng(0)
    centers = np.array([[0.5, 0.5], [3.0, 0.8], [1.8, 3.2]])
    labels = rng.integers(0, C, N)
    X = centers[labels] + rng.standard_normal((N, 2)) * 0.35
    Y = np.eye(C)[labels]
    Z0 = X[rng.choice(N, 12, replace=False)]

    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, 2))
    m.Y = SVGPMultiClassification.define_variable(
        X=m.X, kernel=RBF(input_dim=2, variance=2.0, lengthscale=0.8),
        num_classes=C, shape=(m.n, C),
        inducing_inputs=Variable(shape=Z0.shape, initial_value=Z0),
        whitened=True)

    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]))
    loss = float(infr.run(X=X, Y=Y, max_iter=MAX_ITER, learning_rate=0.05,
                          verbose=False))

    nt = 90
    yt = np.repeat(np.arange(C), nt // C)
    Xt = centers[yt] + rng.standard_normal((nt, 2)) * 0.3
    pred = TransferInference(ModulePredictionAlgorithm(
        model=m, observed=[m.X], target_variables=[m.Y.uuid]),
        infr_params=infr.params)
    p, _ = pred.run(X=Xt)[0]
    acc = float((p[0].argmax(-1).cpu().numpy() == yt).mean())
    print("final -ELBO: {:.2f}".format(loss))
    print("held-out accuracy: {:.3f}".format(acc))
    return acc


if __name__ == "__main__":
    main()
