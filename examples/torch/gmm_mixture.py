"""A Gaussian mixture fitted by gradient MAP.

The PyTorch port of ``examples/gmm_mixture.py``: the component
assignments are marginalized in ``NormalMixture``'s density, so the
weights, means and variances of K = 3 components are fitted by plain
gradient MAP.
"""
import os

import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions import NormalMixture
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.inference import GradBasedInference, MAP

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 300 if SMOKE else 2000
MAX_ITER = 60 if SMOKE else 1200
K = 3


def main():
    rng = np.random.default_rng(0)
    true_w = np.array([0.5, 0.3, 0.2])
    true_mu = np.array([-4.0, 0.0, 3.0])
    true_sd = np.array([0.7, 0.5, 1.0])
    comp = rng.choice(K, N, p=true_w)
    y = rng.normal(true_mu[comp], true_sd[comp])[:, None]

    m = Model()
    m.w = Variable(shape=(K,), transformation=PositiveTransformation(),
                   initial_value=np.ones(K))
    m.mu = Variable(shape=(K,), initial_value=np.array([-1., 0., 1.]))
    m.var = Variable(shape=(K,), transformation=PositiveTransformation(),
                     initial_value=np.ones(K))
    m.y = NormalMixture.define_variable(
        weights=broadcast_to(m.w, (N, 1, K)),
        means=broadcast_to(m.mu, (N, 1, K)),
        variances=broadcast_to(m.var, (N, 1, K)),
        shape=(N, 1))

    infr = GradBasedInference(MAP(model=m, observed=[m.y]))
    infr.run(y=y, max_iter=MAX_ITER, learning_rate=0.05, verbose=False)

    mu_hat = infr.params[m.mu].detach().cpu().numpy().ravel()
    w_hat = infr.params[m.w].detach().cpu().numpy().ravel()
    w_hat = w_hat / w_hat.sum()
    order = np.argsort(mu_hat)
    print("means   (fit):", mu_hat[order].round(2), " true:", true_mu)
    print("weights (fit):", w_hat[order].round(2), " true:", true_w)
    return mu_hat


if __name__ == "__main__":
    main()
