"""Stick-breaking bijector between R^(K-1) and the K-simplex interior.

Counterpart of ``mxfusion_tpu/ops/simplex.py``, used by the mean-field
``StickBreakingNormal`` factor. Convention (NumPyro-style): ``z = 0``
maps to the uniform simplex via the offset ``v_k = sigmoid(z_k -
log(K-1-k))``; the simplex occupies the LAST event axis.
"""
import torch

from .elementwise import softplus as _softplus


def _offsets(k1, like):
    return torch.log(torch.arange(k1, 0, -1, dtype=like.dtype,
                                  device=like.device))


def _logv(z):
    """(log v, log(1-v)) of the offset sigmoids, stable via softplus."""
    t = z - _offsets(z.shape[-1], z)
    return -_softplus(-t), -_softplus(t)


def _log_rem_excl(log1mv):
    """log of the stick left before each break: 0, then the cumulative
    sum of log(1 - v) excluding the current coordinate."""
    return torch.cat([torch.zeros_like(log1mv[..., :1]),
                      torch.cumsum(log1mv[..., :-1], dim=-1)], dim=-1)


def forward(z):
    """R^(..., K-1) -> interior of the (..., K) simplex."""
    logv, log1mv = _logv(z)
    x_head = torch.exp(logv + _log_rem_excl(log1mv))
    x_last = torch.exp(torch.sum(log1mv, dim=-1, keepdim=True))
    return torch.cat([x_head, x_last], dim=-1)


def inverse(x):
    """Simplex (..., K) -> R^(..., K-1); clips by eps at the boundary
    (an exactly-0 coordinate would map to an infinite z)."""
    eps = torch.finfo(x.dtype).eps
    K = x.shape[-1]
    csum = torch.cumsum(x[..., :-1], dim=-1)
    rem = torch.cat([torch.ones_like(x[..., :1]), 1.0 - csum[..., :-1]],
                    dim=-1)
    v = torch.clamp(x[..., :-1] / torch.clamp(rem, min=eps), eps, 1.0 - eps)
    return torch.log(v) - torch.log1p(-v) + _offsets(K - 1, x)


def log_det_jacobian(z):
    """log |dx/dz| of :func:`forward`, summed over the event axis:
    returns shape ``z.shape[:-1]``. Per coordinate,
    dx_k/dv_k = rem_k and dv_k/dz_k = v(1-v)."""
    logv, log1mv = _logv(z)
    return torch.sum(logv + log1mv + _log_rem_excl(log1mv), dim=-1)
