"""Deep GP regression against a single-layer SVGP on a step function.

The PyTorch port of ``examples/deep_gp_regression.py``: a 2-layer
``DeepGPRegression`` (doubly-stochastic VI, propagation draws on the
caller's generator) and an ``SVGPRegression`` baseline fitted to a
noisy step; the RMSE of each predictive mean against the step.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import DeepGPRegression, SVGPRegression
from mxfusion_tpu_torch.inference import (
    GradBasedInference, MAP, ModulePredictionAlgorithm, TransferInference)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 80 if SMOKE else 300
ITER = 60 if SMOKE else 800
M_INDUCING = 8 if SMOKE else 16


def _fit_and_rmse(m, X, Y, truth, num_samples):
    infr = GradBasedInference(
        inference_algorithm=MAP(model=m, observed=[m.X, m.Y]))
    infr.run(max_iter=ITER, learning_rate=0.02, X=X, Y=Y, verbose=False)
    pred = TransferInference(ModulePredictionAlgorithm(
        model=m, observed=[m.X], target_variables=[m.Y.uuid],
        num_samples=num_samples), infr_params=infr.params)
    mu, var = pred.run(X=X)[0]
    return float(np.sqrt(np.mean((mu[0].cpu().numpy() - truth) ** 2)))


def main():
    rng = np.random.default_rng(0)
    X = np.sort(rng.random((N, 1)) * 4, axis=0)
    truth = np.where(X > 2.0, 1.0, -1.0)
    Y = truth + rng.standard_normal((N, 1)) * 0.05

    # --- 2-layer deep GP ---------------------------------------------
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, 1))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    Z0 = np.linspace(0.2, 3.8, M_INDUCING)[:, None]
    Z1 = np.linspace(-1.2, 1.2, M_INDUCING)[:, None]
    m.Y = DeepGPRegression.define_variable(
        X=m.X, kernels=[RBF(input_dim=1), RBF(input_dim=1)],
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=[Variable(shape=Z0.shape, initial_value=Z0),
                         Variable(shape=Z1.shape, initial_value=Z1)],
        jitter=1e-5, num_samples=3)
    deep_rmse = _fit_and_rmse(m, X, Y, truth, num_samples=50)
    print("deep GP (2 layers) RMSE vs step: {:.4f}".format(deep_rmse))

    # --- single-layer SVGP baseline ----------------------------------
    m1 = Model()
    m1.n = Variable()
    m1.X = Variable(shape=(m1.n, 1))
    m1.noise_var = Variable(transformation=PositiveTransformation(),
                            initial_value=0.1)
    m1.Y = SVGPRegression.define_variable(
        X=m1.X, kernel=RBF(input_dim=1), noise_var=m1.noise_var,
        shape=(m1.n, 1),
        inducing_inputs=Variable(shape=Z0.shape, initial_value=Z0),
        jitter=1e-5)
    shallow_rmse = _fit_and_rmse(m1, X, Y, truth, num_samples=1)
    print("single-layer SVGP RMSE vs step: {:.4f}".format(shallow_rmse))

    assert np.isfinite(deep_rmse)
    if not SMOKE:
        assert deep_rmse < 0.25, deep_rmse
    return deep_rmse, shallow_rmse


if __name__ == "__main__":
    main()
