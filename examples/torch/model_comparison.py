"""Model comparison by WAIC, PSIS-LOO and thermodynamic integration.

The PyTorch port of ``examples/model_comparison.py``: two candidate
likelihood variances for the same data, each sampled by HMC and scored
by WAIC and PSIS-LOO on its pointwise log-likelihood matrix, then
compared by their log evidences from power-posterior (thermodynamic)
integration. Every sampler takes its own seeded ``torch.Generator``.
"""
import os

import numpy as np
import torch

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import resolve_device
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.inference import (
    HMCAlgorithm, HMCInference, PowerPosteriorAlgorithm,
    PowerPosteriorInference, loo_psis, pointwise_log_likelihood, waic)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 80
NUM_SAMPLES = 80 if SMOKE else 500
NUM_WARMUP = 60 if SMOKE else 400
CANDIDATES = [("var=1 (true)", 1.0), ("var=25 (wrong)", 25.0)]


def build(lik_var):
    m = Model()
    m.mu = Normal.define_variable(mean=0., variance=100., shape=(1,))
    m.y = Normal.define_variable(mean=broadcast_to(m.mu, (N, 1)),
                                 variance=broadcast_to(
                                     Variable(value=lik_var), (N, 1)),
                                 shape=(N, 1))
    return m


def generator(seed):
    return torch.Generator(resolve_device()).manual_seed(seed)


def main():
    rng = np.random.default_rng(0)
    y = rng.standard_normal((N, 1)) * 1.0 + 2.0   # true variance: 1

    results = {}
    for seed, (name, lik_var) in enumerate(CANDIDATES):
        m = build(lik_var)
        infr = HMCInference(HMCAlgorithm(
            model=m, observed=[m.y], num_samples=NUM_SAMPLES,
            num_warmup=NUM_WARMUP, num_chains=4, num_leapfrog=8))
        infr.run(y=y, generator=generator(seed))
        ll = pointwise_log_likelihood(infr, y=y)["y"]
        w, l = waic(ll), loo_psis(ll)
        results[name] = (w, l)
        print("{:16s} elpd_waic={:8.2f}  elpd_loo={:8.2f}  "
              "p_waic={:.2f}  max pareto_k={:.2f}".format(
                  name, w["elpd_waic"], l["elpd_loo"], w["p_waic"],
                  float(l["pareto_k"].max())))

    best = max(results, key=lambda k: results[k][0]["elpd_waic"])
    print("preferred model:", best)

    # the Bayes factor from the two candidates' evidences
    logZ = {}
    for seed, (name, lik_var) in enumerate(CANDIDATES):
        m = build(lik_var)
        ev = PowerPosteriorInference(PowerPosteriorAlgorithm(
            model=m, observed=[m.y], num_samples=NUM_SAMPLES,
            num_warmup=NUM_WARMUP, num_chains=2,
            num_temps=8 if SMOKE else 16))
        ev.run(y=y, generator=generator(10 + seed))
        logZ[name] = ev.log_evidence
        print("{:16s} TI log-evidence = {:8.2f}".format(
            name, ev.log_evidence))
    names = list(logZ)
    print("log Bayes factor ({} vs {}): {:.1f}".format(
        names[0], names[1], logZ[names[0]] - logZ[names[1]]))
    if not SMOKE:
        assert logZ["var=1 (true)"] > logZ["var=25 (wrong)"]
    return best


if __name__ == "__main__":
    main()
