"""Linalg building blocks for the GP/inference stack.

Counterpart of ``mxfusion_tpu/ops/linalg.py`` (so far the two helpers
the serving path uses).
"""
import torch


def make_diagonal(x):
    """Batched diag-embed: (..., N) -> (..., N, N)."""
    return torch.diag_embed(x)


def broadcast_to_w_samples(x, shape, num_samples):
    """Broadcast ``x`` to ``(num_samples,) + shape`` respecting the sample axis.

    ``x`` carries a leading sample axis (size 1 or num_samples); the
    remaining axes are right-aligned against ``shape`` and broadcast.
    """
    n_target = len(shape)
    n_source = x.ndim - 1
    if n_target - n_source > 0:
        t_shape = (x.shape[0],) + (1,) * (n_target - n_source) + \
            tuple(x.shape[1:])
        x = torch.reshape(x, t_shape)
    return torch.broadcast_to(x, (num_samples,) + tuple(shape))
