"""Elementwise functions that must round as JAX's do.

``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus``:
``torch.nn.functional.softplus`` returns x itself above its threshold of
20, which differs from JAX's in float64 (the Gauss-Hermite tail nodes of
the count SVGPs, the positive bijector and the stick-breaking bijector
all pass 20).
"""
import torch


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))
