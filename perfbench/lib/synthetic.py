"""Inputs the benchmark makes from a seed, on the generator's device."""
import math


def softplus_inverse(y):
    """The unconstrained value whose softplus is ``y``."""
    return y + math.log(-math.expm1(-y))


def regression_data(cfg, rows, generator):
    """(X, Y) of ``rows`` rows: X uniform on [0, box]^input_dim, y =
    sin(2 x0) + 0.3 cos(3 x1) + 0.1 N(0, 1) (``chip_smoke.
    make_training_data``, ``benchmarks/svgp_common.py``)."""
    import torch
    dev = generator.device
    X = torch.rand((rows, cfg["input_dim"]), generator=generator,
                   device=dev) * cfg["box"]
    f = torch.sin(2.0 * X[:, :1]) + 0.3 * torch.cos(3.0 * X[:, 1:2])
    Y = f + 0.1 * torch.randn((rows, 1), generator=generator, device=dev)
    return X, Y
