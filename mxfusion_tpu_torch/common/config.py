"""Global configuration: default dtype and default device.

Counterpart of ``mxfusion_tpu/common/config.py``. JAX places arrays on
its default backend; PyTorch needs a device wherever a tensor is
created, so the port adds a default device. It is CUDA when a card is
present and the CPU otherwise. A device that was asked for is never
swapped silently: asking for CUDA without a card raises.
"""
import torch

_DEFAULT_DTYPE = "float32"
_DEFAULT_DEVICE = None  # None: CUDA when available, else the CPU


def get_default_dtype():
    """Return the default dtype string used for new variables/parameters."""
    return _DEFAULT_DTYPE


def set_default_dtype(dtype):
    """Set the global default dtype ('float32' or 'float64')."""
    global _DEFAULT_DTYPE
    _DEFAULT_DTYPE = dtype


def as_torch_dtype(dtype=None):
    """Resolve a dtype string, a torch dtype, or None (the default)."""
    d = dtype if dtype is not None else _DEFAULT_DTYPE
    if isinstance(d, torch.dtype):
        return d
    return getattr(torch, str(d))


def resolve_device(device=None):
    """Resolve ``device`` (or the default) to a ``torch.device``.

    Raises when CUDA is asked for and no CUDA device is present.
    """
    d = device if device is not None else _DEFAULT_DEVICE
    if d is None:
        d = "cuda" if torch.cuda.is_available() else "cpu"
    d = torch.device(d)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device {} was asked for but torch.cuda.is_available() is "
            "False.".format(d))
    return d


def get_default_device():
    """The device new tensors go to when none is given."""
    return resolve_device(None)


def set_default_device(device):
    """Set the default device ('cuda', 'cuda:1', 'cpu'); None restores
    the automatic choice."""
    global _DEFAULT_DEVICE
    if device is not None:
        resolve_device(device)
    _DEFAULT_DEVICE = device
