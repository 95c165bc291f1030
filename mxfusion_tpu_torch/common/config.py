"""Global configuration: default dtype and default device.

Counterpart of ``mxfusion_tpu/common/config.py``. JAX places arrays on
its default backend; PyTorch needs a device wherever a tensor is
created, so the port adds a default device. It is the card: the port
runs on CUDA unless the caller asks for the CPU, with
``set_default_device("cpu")`` or a ``device="cpu"`` argument. Nothing
is swapped silently: with no card, the default raises until the CPU is
asked for, and asking for CUDA raises.
"""
import torch

_DEFAULT_DTYPE = "float32"
_DEFAULT_DEVICE = None  # None: CUDA, which must be present


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

    Raises when CUDA is asked for, or neither a device nor a default was
    given, and no CUDA device is present.
    """
    d = device if device is not None else _DEFAULT_DEVICE
    if d is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no device was given, no default was set, and "
                "torch.cuda.is_available() is False: the port runs on the "
                "card unless the CPU is asked for. Pass device='cpu' or "
                "call mxfusion_tpu_torch.common.config."
                "set_default_device(\"cpu\").")
        d = "cuda"
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
    the card as the default. Returns the setting it replaced, so that a
    caller can put it back."""
    global _DEFAULT_DEVICE
    if device is not None:
        resolve_device(device)
    old, _DEFAULT_DEVICE = _DEFAULT_DEVICE, device
    return old
