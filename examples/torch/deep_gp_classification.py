"""Deep GP binary classification of a sharp class boundary.

The PyTorch port of ``examples/deep_gp_classification.py``: a 2-layer
``DeepGPClassification`` (Bernoulli-logit output layer) on 1-D inputs
whose class flips at x = 2; prediction returns class-1 probabilities
averaged over propagation draws.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import DeepGPClassification
from mxfusion_tpu_torch.inference import (GradBasedInference, MAP,
                                          ModulePredictionAlgorithm,
                                          TransferInference)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 120 if SMOKE else 400
MAX_ITER = 40 if SMOKE else 600
M_INDUCING = 8 if SMOKE else 16


def sharp_boundary(n, rng):
    """1-D inputs in [0, 4); the class flips at x = 2 with a thin noisy
    band, so the Bayes boundary is a step in input space."""
    X = rng.random((n, 1)) * 4.0
    logits = 12.0 * (X - 2.0)
    p = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.random((n, 1)) < p).astype(np.float64)
    return X, y


def main():
    rng = np.random.default_rng(0)
    X, y = sharp_boundary(N, rng)

    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, 1))
    Z0 = np.linspace(0.2, 3.8, M_INDUCING)[:, None]
    Z1 = np.linspace(-1.2, 1.2, M_INDUCING)[:, None]
    m.Y = DeepGPClassification.define_variable(
        X=m.X, kernels=[RBF(input_dim=1), RBF(input_dim=1)],
        shape=(m.n, 1),
        inducing_inputs=[Variable(shape=Z0.shape, initial_value=Z0),
                         Variable(shape=Z1.shape, initial_value=Z1)],
        jitter=1e-5, num_samples=3)

    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]))
    loss = float(infr.run(X=X, Y=y, max_iter=MAX_ITER, learning_rate=0.02,
                          verbose=False))

    Xt, yt = sharp_boundary(200, rng)
    pred = TransferInference(ModulePredictionAlgorithm(
        model=m, observed=[m.X], target_variables=[m.Y.uuid],
        num_samples=20), infr_params=infr.params)
    p, _ = pred.run(X=Xt)[0]
    p = p[0, :, 0].cpu().numpy()
    acc = float(((p > 0.5) == (yt[:, 0] > 0.5)).mean())
    print("final -ELBO: {:.2f}".format(loss))
    print("held-out accuracy: {:.3f}".format(acc))

    assert np.isfinite(loss)
    if not SMOKE:
        assert acc > 0.9, acc
    return acc


if __name__ == "__main__":
    main()
