"""Stochastic volatility: HMC over an AR(1) log-volatility path.

The PyTorch port of ``examples/stochastic_volatility.py`` (Jacquier,
Polson & Rossi 1994; Kim, Shephard & Chib 1998): returns
y_t ~ N(0, exp(x_t)) with the log-volatility x an AR(1) path
(``GaussianAR1``); HMC samples the whole path, and the posterior mean
and 90% band are held against the true path.
"""
import os

import numpy as np
import torch

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import resolve_device
from mxfusion_tpu_torch.components.distributions import GaussianAR1, Normal
from mxfusion_tpu_torch.components.functions.operators import exp
from mxfusion_tpu_torch.inference import HMCAlgorithm, HMCInference

SMOKE = bool(os.environ.get("MXF_SMOKE"))
T = 60 if SMOKE else 250
SAMPLES = 100 if SMOKE else 500
WARMUP = 100 if SMOKE else 500


def main():
    rng = np.random.default_rng(0)
    phi, sig = 0.95, 0.25
    x = np.zeros(T)
    x[0] = -1.0 + 0.5 * rng.standard_normal()
    for t in range(1, T):
        x[t] = phi * x[t - 1] + sig * rng.standard_normal()
    y = np.exp(x / 2) * rng.standard_normal(T)

    m = Model()
    m.x = GaussianAR1.define_variable(
        phi=Variable(value=phi), noise_var=Variable(value=sig ** 2),
        init_mean=Variable(value=-1.0), init_var=Variable(value=1.0),
        shape=(T,))
    m.y = Normal.define_variable(mean=Variable(value=np.zeros(T)),
                                 variance=exp(m.x), shape=(T,))

    infr = HMCInference(HMCAlgorithm(
        model=m, observed=[m.y], num_samples=SAMPLES, num_chains=2,
        num_warmup=WARMUP, num_leapfrog=16))
    s = infr.run(y=y, generator=torch.Generator(
        resolve_device()).manual_seed(0))
    xs = s[m.x.uuid].cpu().numpy()                # (S, C, T)
    x_post = xs.mean(axis=(0, 1))
    lo, hi = np.percentile(xs, [5, 95], axis=(0, 1))
    corr = float(np.corrcoef(x_post, x)[0, 1])
    cover = ((x >= lo) & (x <= hi)).mean()
    print("accept:", np.round(infr.diagnostics["accept_rate"], 2))
    print("posterior-mean log-vol path: correlation with truth "
          "{:.3f}; 90% band coverage {:.2f}".format(corr, cover))
    if not SMOKE:
        assert corr > 0.5 and cover > 0.75
    return corr


if __name__ == "__main__":
    main()
