"""A bimodal posterior: replica-exchange HMC against plain HMC.

The PyTorch port of ``examples/parallel_tempering.py``: y = x² + noise
with y = 4 has modes at x = ±2. Plain HMC chains stay in the mode they
start in; parallel tempering (6 temperatures, swaps between neighbours)
crosses between them.
"""
import os

import numpy as np
import torch

from mxfusion_tpu_torch import Model
from mxfusion_tpu_torch.common.config import resolve_device
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions.operators import square
from mxfusion_tpu_torch.inference import (
    HMCInference, HMCAlgorithm, ParallelTemperingInference,
    ParallelTemperingAlgorithm)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
SAMPLES = 100 if SMOKE else 800
WARMUP = 100 if SMOKE else 500


def build():
    m = Model()
    m.x = Normal.define_variable(mean=0., variance=25., shape=(1,))
    m.y = Normal.define_variable(mean=square(m.x), variance=0.25,
                                 shape=(1,))
    return m


def mode_crossings(x):
    """The share of consecutive draws (along the first axis) that
    change sign."""
    return float((np.sign(x[:-1]) != np.sign(x[1:])).mean())


def main():
    y = np.array([4.0])
    device = resolve_device()

    m = build()
    hmc = HMCInference(HMCAlgorithm(
        model=m, observed=[m.y], num_samples=SAMPLES, num_chains=4,
        num_warmup=WARMUP))
    x = hmc.run(y=y, generator=torch.Generator(device).manual_seed(0))
    x = x[m.x.uuid].cpu().numpy()
    print("plain HMC: mode-crossing rate {:.4f} (chains stuck; the "
          "apparent mode split {:.2f} is an initialization artifact)"
          .format(mode_crossings(x), (x > 0).mean()))

    m2 = build()
    pt = ParallelTemperingInference(ParallelTemperingAlgorithm(
        model=m2, observed=[m2.y], num_samples=SAMPLES, num_chains=4,
        num_temps=6, num_warmup=WARMUP))
    x2 = pt.run(y=y, generator=torch.Generator(device).manual_seed(0))
    x2 = x2[m2.x.uuid].cpu().numpy()
    flips2 = mode_crossings(x2)
    w_pos = (x2 > 0).mean()
    print("PT (6 temps): mode-crossing rate {:.4f}, mode weights "
          "{:.2f}/{:.2f}, modes at {:+.2f}/{:+.2f}".format(
              flips2, w_pos, 1 - w_pos,
              x2[x2 > 0].mean(), x2[x2 < 0].mean()))
    print("per-pair swap acceptance:",
          np.round(pt.diagnostics["swap_accept_rate"], 2))
    if not SMOKE:
        assert flips2 > 0.05 and 0.35 < w_pos < 0.65
    return flips2


if __name__ == "__main__":
    main()
