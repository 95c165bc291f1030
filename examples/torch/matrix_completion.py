"""Probabilistic matrix completion with an observation mask.

The PyTorch port of ``examples/matrix_completion.py``: PPCA over a
120 × 8 matrix of which 40% of the entries are held out; an array
``rv_scaling`` masks them out of the likelihood, and the learned factors
impute them.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions.operators import (broadcast_to,
                                                               dot)
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference,
    create_Gaussian_meanfield)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N, K, D = 120, 3, 8
MAX_ITER = 50 if SMOKE else 2500


def main():
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((K, D))
    z_true = rng.standard_normal((N, K))
    x_full = z_true @ w_true + rng.standard_normal((N, D)) * 0.1

    mask = (rng.random((N, D)) < 0.6).astype(np.float64)  # 60% observed
    x_train = np.where(mask > 0, x_full, 0.0)             # placeholder

    m = Model()
    m.w = Variable(shape=(K, D),
                   initial_value=rng.standard_normal((K, D)) * 0.1)
    m.z = Normal.define_variable(
        mean=broadcast_to(Variable(value=0.), (N, K)),
        variance=broadcast_to(Variable(value=1.), (N, K)),
        shape=(N, K))
    m.x_mean = dot(m.z, m.w)
    m.noise = Variable(transformation=PositiveTransformation(),
                       initial_value=0.1)
    m.x = Normal.define_variable(mean=m.x_mean,
                                 variance=broadcast_to(m.noise, (N, D)),
                                 shape=(N, D))

    q = create_Gaussian_meanfield(model=m, observed=[m.x])
    alg = StochasticVariationalInference(num_samples=5, model=m,
                                         posterior=q, observed=[m.x])
    infr = GradBasedInference(inference_algorithm=alg)
    infr.run(max_iter=MAX_ITER, learning_rate=0.05, x=x_train,
             rv_scaling={m.x: mask}, verbose=not SMOKE)

    z_post = infr.params[q.z.factor.mean].detach().cpu().numpy()
    w_post = infr.params[m.w].detach().cpu().numpy()
    recon = z_post.reshape(N, K) @ w_post.reshape(K, D)
    held_out = mask == 0
    err_model = float(np.abs(recon - x_full)[held_out].mean())
    col_mean = x_train.sum(0) / np.maximum(mask.sum(0), 1.0)
    err_base = np.abs(np.broadcast_to(col_mean, x_full.shape)
                      - x_full)[held_out].mean()
    print("held-out imputation error: {:.3f} (column-mean baseline "
          "{:.3f})".format(err_model, err_base))
    if not SMOKE:
        assert err_model < 0.35 * err_base, (err_model, err_base)
    return err_model


if __name__ == "__main__":
    main()
