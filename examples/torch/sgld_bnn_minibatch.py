"""Minibatch SGLD on a large linear regression.

The PyTorch port of ``examples/sgld_bnn_minibatch.py``: preconditioned
SGLD with one minibatch gradient per chain step (B = 256 of N = 20000
rows, gathered on the data's device), against the closed-form
posterior mean.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions.operators import (broadcast_to,
                                                               dot)
from mxfusion_tpu_torch.inference import (SGLDAlgorithm, SGLDInference,
                                          potential_scale_reduction)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N, D, S2, B = 20_000, 8, 0.25, 256
NUM_SAMPLES = 100 if SMOKE else 3000
NUM_BURNIN = 100 if SMOKE else 1500


def main():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    w_true = rng.standard_normal((D, 1)).astype(np.float32)
    y = X @ w_true + rng.standard_normal((N, 1)).astype(np.float32) \
        * np.sqrt(S2)

    m = Model()
    m.n = Variable()                       # symbolic data dim: binds to B
    m.X = Variable(shape=(m.n, D))
    m.w = Normal.define_variable(
        mean=broadcast_to(Variable(value=0.), (D, 1)),
        variance=broadcast_to(Variable(value=1.), (D, 1)),
        shape=(D, 1))
    m.f = dot(m.X, m.w)
    m.y = Normal.define_variable(
        mean=m.f, variance=broadcast_to(Variable(value=S2), (m.n, 1)),
        shape=(m.n, 1))

    alg = SGLDAlgorithm(model=m, observed=[m.X, m.y],
                        num_samples=NUM_SAMPLES, num_burnin=NUM_BURNIN,
                        num_chains=4, batch_size=B, step_size=5e-5,
                        step_decay_gamma=0.0, preconditioning=True)
    infr = SGLDInference(inference_algorithm=alg)
    samples = infr.run(X=X, y=y)

    draws = samples[m.w.uuid]                    # (S, chains, D, 1)
    flat = draws.reshape(-1, D).cpu().numpy().astype(np.float64)
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    Sigma = np.linalg.inv(X64.T @ X64 / S2 + np.eye(D))
    mu = Sigma @ X64.T @ y64[:, 0] / S2
    rhat = potential_scale_reduction(draws[..., 0]).cpu().numpy()
    print("posterior mean (SGLD):  ", flat.mean(0).round(3))
    print("posterior mean (exact): ", mu.round(3))
    print("split R-hat:            ", rhat.round(3))
    err = float(np.abs(flat.mean(0) - mu).max())
    print("max abs error:", err)
    return err


if __name__ == "__main__":
    main()
