"""Correlated multi-output regression with the linear model of
coregionalization.

The PyTorch port of ``examples/lmc_multioutput.py``: C = 3 outputs mixed
by a trainable (Q, C) matrix from Q = 2 shared-kernel latent SVGPs
(``LMCSVGPRegression``); the held-out error against the noise-free
truth and the learned output correlation.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import LMCSVGPRegression
from mxfusion_tpu_torch.inference import (GradBasedInference, MAP,
                                          ModulePredictionAlgorithm,
                                          TransferInference)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
MAX_ITER = 60 if SMOKE else 1200
N, C, Q = 120, 3, 2


def corr(A):
    d = np.sqrt(np.diag(A))
    return A / np.outer(d, d)


def main():
    rng = np.random.default_rng(0)
    X = np.sort(rng.random((N, 1)) * 6, axis=0)
    latents = np.stack([np.sin(X[:, 0]), np.cos(1.3 * X[:, 0])], -1)
    W_true = np.array([[1.0, 0.5, -1.0],
                       [0.2, -0.8, 0.4]])          # (Q, C)
    Y = latents @ W_true + rng.standard_normal((N, C)) * 0.05

    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, 1))
    m.Y = LMCSVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=1, variance=1.0, lengthscale=1.0),
        num_outputs=C, num_latents=Q, shape=(m.n, C),
        inducing_inputs=Variable(
            shape=(16, 1),
            initial_value=np.linspace(0.1, 5.9, 16)[:, None]))

    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]))
    loss = infr.run(X=X, Y=Y, max_iter=MAX_ITER, learning_rate=0.03,
                    verbose=not SMOKE)
    print("final loss:", float(loss))

    Xt = np.linspace(0.05, 5.95, 60)[:, None]
    pred = TransferInference(ModulePredictionAlgorithm(
        model=m, observed=[m.X], target_variables=[m.Y.uuid]),
        infr_params=infr.params)
    mu, var = pred.run(X=Xt)[0]
    mu = mu[0].cpu().numpy()
    truth = np.stack([np.sin(Xt[:, 0]), np.cos(1.3 * Xt[:, 0])],
                     -1) @ W_true
    rmse = float(np.sqrt(((mu - truth) ** 2).mean()))
    print("held-out RMSE vs noise-free truth: {:.4f}".format(rmse))

    # the mixing matrix is identified only up to a latent rotation and
    # an overall scale traded against the kernel variance: the invariant
    # is the correlation structure of WᵀW
    W = infr.params[m.Y.factor.mixing_matrix].detach().cpu().numpy()
    W = W.reshape(Q, C)
    print("output correlation (true):\n",
          np.round(corr(W_true.T @ W_true), 3))
    print("output correlation (learned):\n", np.round(corr(W.T @ W), 3))
    if not SMOKE:
        assert rmse < 0.1, rmse
        assert np.allclose(corr(W_true.T @ W_true), corr(W.T @ W),
                           atol=0.15)
    return rmse


if __name__ == "__main__":
    main()
