"""PILCO: model-based policy evaluation by rolling GP dynamics forward.

Counterpart of ``mxfusion_tpu/inference/pilco_alg.py``. The rollout is a
Python loop over ``n_time_steps``: each step writes the state-action
inputs into the env, asks the dynamics module (a ``GPRegression``) for
its predictive mean on the cached posterior state, and adds the
caller's cost. On the card each step's Kxt is one K1 launch, and the
gradient in the policy's weights flows back through K1's backward into
the test inputs.
"""
import inspect

import torch

from .inference_alg import SamplingAlgorithm
from ..common.config import get_default_dtype


def _call_flex(fn, *args, env=None):
    """Call ``fn(*args)`` or ``fn(*args, env)`` depending on its arity, so
    that policies and costs may read trainable variables from the env."""
    try:
        n = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n = len(args)
    if env is not None and n > len(args):
        return fn(*args, env)
    return fn(*args)


class PILCOAlgorithm(SamplingAlgorithm):
    """The expected cost of ``n_time_steps`` of ``policy`` under the
    model's GP dynamics (``model.X`` the state-action inputs, ``model.Y``
    the next state), from ``num_samples`` initial states. ``policy`` and
    ``cost_function`` are the caller's torch code; either may take the
    env as its last argument to read trainable variables (a policy
    weight)."""

    def __init__(self, model, observed, cost_function, policy, n_time_steps,
                 initial_state_generator, extra_graphs=None, num_samples=3,
                 dtype=None):
        super().__init__(model=model, observed=observed,
                         num_samples=num_samples, extra_graphs=extra_graphs)
        self.cost_function = cost_function
        self.policy = policy
        self.initial_state_generator = initial_state_generator
        self.n_time_steps = n_time_steps
        self.dtype = dtype if dtype is not None else get_default_dtype()

    def compute(self, env, ctx):
        """Roll the dynamics forward under the policy and return the
        cost summed over the horizon, as (loss, loss for the gradient).
        Each step writes the inputs into ``env`` itself: the module
        looks its variables up there."""
        s_0 = self.initial_state_generator(self.num_samples)
        a_0 = _call_flex(self.policy, s_0, env=env)
        a_t_plus_1 = a_0
        x_t = torch.unsqueeze(torch.cat([s_0, a_0], dim=-1), 1)
        cost = 0.0
        for _ in range(self.n_time_steps):
            env[self.model.X.uuid] = x_t
            res = self.model.Y.factor.predict(
                env, ctx.next_generator(), targets=[self.model.Y.uuid],
                num_samples=self.num_samples)[0]
            s_t_plus_1 = res[0]
            cost = cost + _call_flex(self.cost_function, s_t_plus_1,
                                     a_t_plus_1, env=env)
            a_t_plus_1 = _call_flex(self.policy, s_t_plus_1, env=env)
            x_t = torch.cat(
                [s_t_plus_1, torch.unsqueeze(a_t_plus_1, -1)
                 if a_t_plus_1.ndim < s_t_plus_1.ndim else a_t_plus_1],
                dim=-1)
        total_cost = torch.sum(cost)
        return total_cost, total_cost
