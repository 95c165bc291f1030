"""A structural time series: a local-linear-trend state-space model.

The PyTorch port of ``examples/state_space_timeseries.py``: the slope
and observation noise variances of a ``LinearGaussianSSM`` fitted by
MAP through the Kalman marginal likelihood (the parallel-in-time
filter); then the sequential filter, the RTS
smoother's trend and one-step-ahead forecasts (``ops.kalman``) on the
package's device.
"""
import os

import numpy as np
import torch

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import resolve_device
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions import LinearGaussianSSM
from mxfusion_tpu_torch.components.functions.operators import (broadcast_to,
                                                               multiply)
from mxfusion_tpu_torch.inference import GradBasedInference, MAP
from mxfusion_tpu_torch.ops.kalman import kalman_filter, rts_smoother

SMOKE = bool(os.environ.get("MXF_SMOKE"))
T = 200
MAX_ITER = 40 if SMOKE else 800

A = np.array([[1.0, 1.0], [0.0, 1.0]])      # level += slope
H = np.array([[1.0, 0.0]])
Q_BASIS = np.diag([0.0, 1.0])               # noise drives the slope
M0 = np.array([0.0, 0.1])
P0 = np.eye(2)


def main():
    rng = np.random.default_rng(0)
    slope = 0.1 + np.cumsum(rng.standard_normal(T) * 0.02)
    level = np.cumsum(slope)
    y = (level + rng.standard_normal(T) * 1.0)[:, None]

    m = Model()
    m.q = Variable(transformation=PositiveTransformation(),
                   initial_value=0.1)        # slope-noise variance
    m.r = Variable(transformation=PositiveTransformation(),
                   initial_value=0.5)        # observation variance
    m.y = LinearGaussianSSM.define_variable(
        A=Variable(value=A), H=Variable(value=H),
        trans_cov=multiply(broadcast_to(m.q, (2, 2)),
                           Variable(value=Q_BASIS)),
        obs_cov=multiply(broadcast_to(m.r, (1, 1)),
                         Variable(value=np.eye(1))),
        initial_mean=Variable(value=M0),
        initial_cov=Variable(value=P0), shape=(T, 1),
        # the same likelihood by the parallel-in-time filter: a few
        # launches a level of its scan where the sequential one loops
        # over the T steps on the host
        parallel_filter=True)

    infr = GradBasedInference(MAP(model=m, observed=[m.y]))
    infr.run(y=y, max_iter=MAX_ITER, learning_rate=0.05,
             verbose=not SMOKE)
    q_hat = infr.params[m.q].flatten()[0].item()
    r_hat = infr.params[m.r].flatten()[0].item()
    print("fitted slope-noise var {:.4f} (true 0.0004/step grows the "
          "slope), obs var {:.3f} (true 1.0)".format(q_hat, r_hat))

    device = resolve_device()

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    out = kalman_filter(f32(y), f32(A), f32(H), f32(q_hat * Q_BASIS),
                        f32(r_hat * np.eye(1)), f32(M0), f32(P0))
    sm, _ = rts_smoother(out["filtered_means"], out["filtered_covs"],
                         out["pred_means"], out["pred_covs"], f32(A))
    trend_err = float(np.abs(sm[:, 0].cpu().numpy() - level).mean())
    pred = out["y_pred_means"][:, 0].cpu().numpy()
    rmse_model = float(np.sqrt(np.mean((pred[1:] - y[1:, 0]) ** 2)))
    rmse_naive = np.sqrt(np.mean((y[:-1, 0] - y[1:, 0]) ** 2))
    print("smoothed-trend error: {:.3f}".format(trend_err))
    print("one-step-ahead RMSE: {:.3f} (naive last-value {:.3f})"
          .format(rmse_model, rmse_naive))
    if not SMOKE:
        assert rmse_model < rmse_naive
        assert trend_err < 1.0
    return rmse_model


if __name__ == "__main__":
    main()
