"""Faults planted under the timed path, to show that the comparison
catches them: each is a context manager that breaks the program while
it is open. Used by ``calibrate.py`` on the card and by the tests."""
import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def unchanged_state():
    """Every optimizer step returns the state unchanged."""
    return _patched(torch.optim.Adam, "step",
                    lambda original: lambda self, closure=None: None)


def half_batch():
    """Each step's second half of the batch is left out: the first half
    stands in its place, so the loss is the mean over the rest."""
    from mxfusion_tpu_torch.inference.grad_loop import GradLoop

    def replacement(original):
        def step(self, executor, opt, trainable, fixed, batch, generator,
                 grad_norm=False):
            halved = [torch.cat([x[:x.shape[0] // 2]] * 2)[:x.shape[0]]
                      for x in batch]
            return original(self, executor, opt, trainable, fixed, halved,
                            generator, grad_norm)
        return step
    return _patched(GradLoop, "_step", replacement)


def altered_answer(share=1e-2):
    """The first predicted mean of every chunk moved by ``share`` of the
    chunk's largest mean in magnitude, where the module produces it."""
    from mxfusion_tpu_torch.modules.gp_modules.svgp_regression import \
        SVGPRegressionMeanVariancePrediction as P

    def replacement(original):
        def moments(self, env):
            mu, var = original(self, env)
            mu = mu.clone()
            mu[..., 0, :] += share * mu.abs().max()
            return mu, var
        return moments
    return _patched(P, "_moments", replacement)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
