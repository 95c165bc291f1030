"""Runtime sample-dimension conventions.

Counterpart of ``mxfusion_tpu/components/variables/runtime_variable.py``.
Every runtime tensor carries a leading *sample axis*: size 1 means "not
sampled" (shared across samples), size > 1 means per-sample values.
"""
import torch


def as_samples(array, num_samples):
    """Broadcast the sample axis to ``num_samples`` (a view)."""
    if array.shape[0] == num_samples:
        return array
    return array.expand((num_samples,) + tuple(array.shape[1:]))


def align_sample_arrays(arrays):
    """Right-align event dims across arrays that share the sample axis.

    Axis 0 is the sample axis; the remaining (event) dims broadcast
    right-aligned, so an (s, 1) scalar aligns against (s, N, 1) values
    as (s, 1, 1). Non-arrays pass through.
    """
    rank = 0
    for a in arrays:
        if isinstance(a, torch.Tensor):
            rank = max(rank, a.ndim)
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor) and 1 <= a.ndim < rank:
            a = torch.reshape(a, (a.shape[0],) + (1,) * (rank - a.ndim)
                              + tuple(a.shape[1:]))
        out.append(a)
    return out


def arrays_as_samples(arrays):
    """Broadcast a list of tensors (or dicts of tensors) to a common
    sample count."""
    num = 1
    for a in arrays:
        if isinstance(a, dict):
            for v in a.values():
                if isinstance(v, torch.Tensor) and v.ndim > 0:
                    num = max(num, v.shape[0])
        elif isinstance(a, torch.Tensor) and a.ndim > 0:
            num = max(num, a.shape[0])
    out = []
    for a in arrays:
        if isinstance(a, dict):
            out.append({k: (as_samples(v, num)
                            if isinstance(v, torch.Tensor) and v.ndim > 0
                            else v)
                        for k, v in a.items()})
        elif isinstance(a, torch.Tensor) and a.ndim > 0:
            out.append(as_samples(a, num))
        else:
            out.append(a)
    return out
