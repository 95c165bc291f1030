"""Large-scale SVGP regression on the device-resident data path.

The PyTorch port of ``examples/svgp_large_scale.py``: the data live on
the device and ``DeviceMinibatchLoop`` shuffles and gathers each epoch
there (whitened q(U)); then bulk serving over a ``parallel`` mesh
(``BatchedPredictor(mesh=)``, whole chunks dealt to the ranks) equals
the direct prediction. Without a process group the mesh is a world of
one, which this script starts and tears down.
"""
import os
import time

import numpy as np
import torch.distributed as dist

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.inference import (MAP, BatchedPredictor,
                                          DeviceMinibatchLoop,
                                          GradBasedInference,
                                          ModulePredictionAlgorithm,
                                          TransferInference)
from mxfusion_tpu_torch.parallel import make_mesh

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 2_000 if SMOKE else 200_000
BATCH = 500 if SMOKE else 4096
M_INDUCING = 16 if SMOKE else 128
EPOCHS = 3 if SMOKE else 30
D = 4


def main():
    rng = np.random.default_rng(0)
    X = (rng.random((N, D)) * 4).astype(np.float32)
    f = np.sin(X[:, :1] * 2.0) + 0.3 * np.cos(X[:, 1:2] * 3.0)
    Y = (f + rng.standard_normal((N, 1)) * 0.1).astype(np.float32)

    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.5)
    kernel = RBF(input_dim=D, variance=1.0, lengthscale=1.0)
    # whitened=True: q over v = L⁻¹u (KL against N(0, I)), the
    # recommended parameterization
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=kernel, noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=Variable(shape=(M_INDUCING, D),
                                 initial_value=rng.random(
                                     (M_INDUCING, D)) * 4),
        whitened=True)

    loop = DeviceMinibatchLoop(batch_size=BATCH,
                               rv_scaling={m.Y: N / BATCH})
    infr = GradBasedInference(
        inference_algorithm=MAP(model=m, observed=[m.X, m.Y]),
        grad_loop=loop)

    losses = []
    t0 = time.perf_counter()
    infr.run(max_iter=EPOCHS, learning_rate=5e-3, X=X, Y=Y,
             callback=lambda e, l: losses.append(float(l)))
    dt = time.perf_counter() - t0
    print("{} points, {} epochs in {:.1f}s; scaled -ELBO {:.4g} -> {:.4g}"
          .format(N, EPOCHS, dt, losses[0], losses[-1]))
    assert losses[-1] < losses[0]

    Xt = X[:256]
    pred = TransferInference(ModulePredictionAlgorithm(
        model=m, observed=[m.X], target_variables=[m.Y.uuid]),
        infr_params=infr.params)
    mu, var = pred.run(X=Xt)[0]
    mu = mu.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mu[0, :, 0] - f[:256, 0]) ** 2)))
    print("prediction RMSE vs true f on 256 train points: {:.4f}"
          .format(rmse))

    # bulk serving over the mesh: whole fixed-size chunks dealt to the
    # ranks, their outputs all-gathered
    started = not dist.is_initialized()
    mesh = make_mesh()
    try:
        served = BatchedPredictor(
            model=m, infr_params=infr.params, observed=[m.X],
            target_variables=[m.Y.uuid], chunk_size=64 * mesh.size(),
            mesh=mesh)
        mu_s, _ = served.predict(X=Xt)[0]
        np.testing.assert_allclose(mu_s, mu, rtol=1e-4, atol=1e-6)
        print("sharded serving over {} devices matches the direct "
              "prediction".format(mesh.size()))
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
