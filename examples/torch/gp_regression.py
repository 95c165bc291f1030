"""Exact GP regression with the GPRegression module.

The PyTorch port of ``examples/gp_regression.py``: fit the kernel's
hyperparameters by maximizing the marginal likelihood, then predict the
mean and variance at test inputs through the cached Cholesky. On the
card every RBF gram (Kxx per step, Kxt per prediction) is one launch of
the port's RBF kernel.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import GPRegression
from mxfusion_tpu_torch.inference import (
    GradBasedInference, MAP, ModulePredictionAlgorithm, TransferInference,
    BatchInferenceLoop)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 60
MAX_ITER = 30 if SMOKE else 300


def main():
    rng = np.random.default_rng(0)
    X = rng.random((N, 1)) * 4
    Y = np.sin(X) + rng.standard_normal((N, 1)) * 0.1

    m = Model()
    m.N = Variable()
    m.X = Variable(shape=(m.N, 1))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    m.Y = GPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=1, variance=1., lengthscale=1.),
        noise_var=m.noise_var, shape=(m.N, 1))

    # per-step metrics (loss, the gradient's global norm, the step's
    # wall time on the host)
    history = []
    loop = BatchInferenceLoop(
        metrics_callback=lambda i, mtr: history.append(mtr))
    infr = GradBasedInference(
        inference_algorithm=MAP(model=m, observed=[m.X, m.Y]),
        grad_loop=loop)
    infr.run(max_iter=MAX_ITER, learning_rate=0.05, X=X, Y=Y,
             verbose=not SMOKE)
    print("first/last metrics: {} -> {}".format(
        {k: round(v, 4) for k, v in history[0].items()},
        {k: round(v, 4) for k, v in history[-1].items()}))
    kernel = m.Y.factor._module_graph.kernel
    print("lengthscale: {:.3f}, variance: {:.3f}, noise: {:.4f}".format(
        infr.params[kernel.lengthscale].flatten()[0].item(),
        infr.params[kernel.variance].flatten()[0].item(),
        infr.params[m.noise_var].flatten()[0].item()))

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
