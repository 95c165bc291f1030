"""Bayesian linear regression sampled by HMC.

The PyTorch port of ``examples/hmc_regression.py``: 4 chains of
``HMCAlgorithm`` (dual-averaged step size, 12 leapfrog steps) on a
conjugate model whose posterior is known in closed form; the draws'
mean against it and the split R-hat.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions.operators import (broadcast_to,
                                                               dot)
from mxfusion_tpu_torch.inference import (HMCAlgorithm, HMCInference,
                                          potential_scale_reduction)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N, D, S2 = 120, 4, 0.25
NUM_SAMPLES = 60 if SMOKE else 1000
NUM_WARMUP = 40 if SMOKE else 500


def main():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D))
    w_true = rng.standard_normal((D, 1))
    y = X @ w_true + rng.standard_normal((N, 1)) * np.sqrt(S2)

    m = Model()
    m.X = Variable(shape=(N, D))
    m.w = Normal.define_variable(
        mean=broadcast_to(Variable(value=0.), (D, 1)),
        variance=broadcast_to(Variable(value=1.), (D, 1)),
        shape=(D, 1))
    m.f = dot(m.X, m.w)
    m.y = Normal.define_variable(
        mean=m.f, variance=broadcast_to(Variable(value=S2), (N, 1)),
        shape=(N, 1))

    alg = HMCAlgorithm(model=m, observed=[m.X, m.y],
                       num_samples=NUM_SAMPLES, num_warmup=NUM_WARMUP,
                       num_chains=4, num_leapfrog=12)
    infr = HMCInference(inference_algorithm=alg)
    samples = infr.run(X=X, y=y)

    draws = samples[m.w.uuid]                    # (S, chains, D, 1)
    flat = draws.reshape(-1, D).cpu().numpy()
    Sigma = np.linalg.inv(X.T @ X / S2 + np.eye(D))
    mu = Sigma @ X.T @ y[:, 0] / S2
    rhat = potential_scale_reduction(draws[..., 0]).cpu().numpy()
    print("posterior mean (HMC):   ", flat.mean(0).round(3))
    print("posterior mean (exact): ", mu.round(3))
    print("accept rate per chain:  ",
          np.round(infr.diagnostics["accept_rate"], 2))
    print("split R-hat:            ", rhat.round(3))
    err = float(np.abs(flat.mean(0) - mu).max())
    print("max abs error:", err)
    return err


if __name__ == "__main__":
    main()
