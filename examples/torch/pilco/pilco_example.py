"""Model-based reinforcement learning with PILCO.

The PyTorch port of ``examples/pilco/pilco_example.py``: fit GP
dynamics (``GPRegression`` by MAP) to transitions of s' = 0.9 s + 0.4 a,
then learn a linear policy gain by rolling the dynamics forward under
it (``PILCOAlgorithm``) and descending the expected trajectory cost
(``GradTransferInference``, the dynamics frozen). The policy and the
cost are plain torch functions; the policy reads its trainable gain
from the env.
"""
import os

import numpy as np
import torch

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import GPRegression
from mxfusion_tpu_torch.inference import (
    GradBasedInference, MAP, PILCOAlgorithm, GradTransferInference)

SMOKE = bool(os.environ.get("MXF_SMOKE"))
DYN_ITER = 50 if SMOKE else 300
POLICY_ITER = 20 if SMOKE else 150


def env_step(s, a):
    return 0.9 * s + 0.4 * a


def main():
    rng = np.random.default_rng(0)
    n = 80
    S = rng.standard_normal((n, 1)) * 1.5
    A = rng.uniform(-1, 1, (n, 1))
    S_next = env_step(S, A) + rng.standard_normal((n, 1)) * 0.01
    X = np.concatenate([S, A], axis=-1)

    m = Model()
    m.N = Variable()
    m.X = Variable(shape=(m.N, 2))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.01)
    m.Y = GPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=2, variance=1., lengthscale=1.),
        noise_var=m.noise_var, shape=(m.N, 1))
    dyn_infr = GradBasedInference(
        inference_algorithm=MAP(model=m, observed=[m.X, m.Y]))
    dyn_infr.run(max_iter=DYN_ITER, learning_rate=0.05, X=X, Y=S_next)

    policy_w = Variable(shape=(1, 1), initial_value=np.zeros((1, 1)))
    m.policy_w = policy_w
    params = dyn_infr.params

    def policy(s, env):
        return s @ env[policy_w.uuid][0]

    def cost(s, a, env):
        return torch.sum(torch.square(s))

    alg = PILCOAlgorithm(
        model=m, observed=[], cost_function=cost, policy=policy,
        n_time_steps=10,
        initial_state_generator=lambda k: torch.ones(
            (k, 1), dtype=params.dtype, device=params.device),
        num_samples=4)
    pilco_infr = GradTransferInference(
        inference_algorithm=alg, infr_params=params)
    losses = []
    pilco_infr.run(max_iter=POLICY_ITER, learning_rate=0.1,
                   callback=lambda i, l: losses.append(float(l)))
    w = pilco_infr.params[policy_w].flatten()[0].item()
    print("trajectory cost: {:.2f} -> {:.2f}; learned gain {:.3f}".format(
        losses[0], losses[-1], w))
    return w


if __name__ == "__main__":
    main()
