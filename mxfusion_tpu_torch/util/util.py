"""Misc helpers.

Counterpart of ``mxfusion_tpu/util/util.py``.
"""
import ast

import torch


def slice_axis(array, axis, indices):
    """Take ``indices`` along ``axis`` (used by kernel active_dims)."""
    idx = torch.as_tensor(indices, dtype=torch.long, device=array.device)
    return torch.index_select(array, axis % array.ndim, idx)


def rename_duplicate_names(names):
    """Given [(name, obj)], suffix duplicates with _0, _1, ... in order."""
    counts = {}
    for name, _ in names:
        counts[name] = counts.get(name, 0) + 1
    seen = {}
    out = []
    for name, obj in names:
        if counts[name] > 1:
            idx = seen.get(name, 0)
            seen[name] = idx + 1
            out.append((name + "_" + str(idx), obj))
        else:
            out.append((name, obj))
    return out


def parse_string_to_tuple(s):
    """Parse '(1, 2)' into (1, 2) safely."""
    return tuple(ast.literal_eval(s))
