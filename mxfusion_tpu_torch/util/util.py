"""Misc helpers."""
import torch


def slice_axis(array, axis, indices):
    """Take ``indices`` along ``axis`` (used by kernel active_dims)."""
    idx = torch.as_tensor(indices, dtype=torch.long, device=array.device)
    return torch.index_select(array, axis % array.ndim, idx)
