"""Parameters placed over a mesh, and the whole tensor every reader sees.

``parallel.device_put`` places a parameter over a mesh axis as a
:class:`torch.distributed.tensor.DTensor`: each rank of the axis holds
its block of rows. What reads a parameter (an objective's env, ``save``,
a checkpoint, a predictor) sees the whole tensor, as ``np.asarray`` sees
a sharded array in JAX: :func:`whole` gathers it.
"""
import sys


def is_sharded(t):
    """Whether ``t`` is a DTensor. No DTensor exists before
    ``torch.distributed.tensor`` is imported, so a run without a mesh
    never imports it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def whole(t):
    """The whole tensor of a DTensor, dense and contiguous, gathered over
    its mesh: a collective that every rank of the mesh takes part in.
    Differentiable: the backward hands each rank the gradient of its own
    block and sums nothing over the axis the blocks lie on, since every
    rank of that axis computed the same rows. Any other ``t`` comes back
    as it is."""
    if not is_sharded(t):
        return t
    return t.full_tensor().contiguous()
