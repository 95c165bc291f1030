"""Device meshes over ``torch.distributed``.

Counterpart of ``mxfusion_tpu/parallel/mesh.py``. JAX keeps one process
per host, a mesh over its devices and GSPMD inserting the collectives.
PyTorch has no compiler to partition a program, so the port runs one
process per device (NCCL between cards, gloo between CPU processes) and
a mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
processes' ranks, with ``mesh_dim_names`` ``("data",)`` or
``("data", "model")``. An array "sharded" over the data axis is, in
each process, that rank's contiguous block of axis 0 on its device; the
loops that take such data (``parallel.data_parallel``) add the
collectives themselves.

A :class:`Sharding` is the port's counterpart of a ``NamedSharding``: a
mesh, a data axis and a placement, ``Shard(0)`` (each rank holds its
block of axis 0) or ``Replicate()`` (every rank holds the whole array).
``batch_sharding`` and ``replicated_sharding`` make them, and the loops'
``data_sharding=`` takes a list of them.

A parameter placed over an axis (:func:`device_put` with a sharding that
shards, as JAX places q(U) and Z over ``"model"``) is a
:class:`torch.distributed.tensor.DTensor`: each rank holds its block of
rows. An objective gathers it into the whole tensor before its transform
(``inference_alg``'s env builder), and the gather's backward gives each
rank its block's gradient, so any step the caller writes partitions
itself as a jitted step does under GSPMD.
"""
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..common.config import resolve_device
from ..common.placement import is_sharded, whole

DATA_AXIS = "data"


def _backend():
    """NCCL for CUDA tensors where the card is present, gloo for CPU
    tensors always."""
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def _ensure_process_group():
    """A world of one in this process when no process group exists: an
    in-process ``HashStore`` stands in for the rendezvous, so it needs no
    address, port or environment variable."""
    if not dist.is_initialized():
        dist.init_process_group(_backend(), store=dist.HashStore(),
                                rank=0, world_size=1)


def _device_type():
    """The mesh's device type: the package's default device's (the card
    where present, NCCL; the CPU otherwise, gloo)."""
    return resolve_device(None).type


def make_mesh(n_devices=None, axis_name=DATA_AXIS, devices=None):
    """1-D mesh over the first ``n_devices`` ranks (default: all).

    Without a process group (no :func:`initialize_distributed` with more
    than one process) this process becomes a world of one, over an
    in-process store, and the mesh has one rank: the data-parallel loops
    then run their collectives over that one rank. ``devices``: the
    ranks, in order (default ``range(n_devices)``). The device type is
    the package's default device's."""
    _ensure_process_group()
    world = dist.get_world_size()
    ranks = list(devices) if devices is not None else list(range(world))
    if n_devices is not None:
        ranks = ranks[:n_devices]
    if len(ranks) != world:
        raise ValueError(
            "a mesh spans every process of the group: {} ranks asked for, "
            "{} processes joined. Start as many processes as the mesh has "
            "devices.".format(len(ranks), world))
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_device_type(), torch.as_tensor(ranks),
                      mesh_dim_names=(axis_name,))


def make_mesh_2d(data_size, model_size, data_axis=DATA_AXIS,
                 model_axis="model", devices=None):
    """2-D (data × model) mesh: rank ``r`` sits at
    ``(r // model_size, r % model_size)``. Data shards over the data
    axis: ranks that share a data coordinate hold the same rows. A
    parameter placed over the model axis (:func:`device_put` with
    ``batch_sharding(mesh, ndim, "model")``) is held as each model-axis
    rank's block of rows; every other parameter is replicated.

    Guidance, as in the JAX package: sharding the M-inducing axis of
    q(U) and Z over ``model`` is a MEMORY-CAPACITY lever, not a speed
    lever. It divides the M² q(U) parameters and their Adam moments by
    the axis size, but each step all-gathers every placed parameter and
    computes the rest replicated (Kuu's Cholesky is whole on every rank
    regardless), so it adds collectives and no compute-rate benefit.
    Replicate q(U) (``model_size=1``) unless its parameters and Adam
    state approach a device's memory (M of about 16k in float32)."""
    _ensure_process_group()
    need = data_size * model_size
    ranks = list(devices) if devices is not None else list(range(need))
    if len(ranks) != need or need != dist.get_world_size():
        raise ValueError(
            "a {} x {} mesh needs {} processes; {} joined.".format(
                data_size, model_size, need, dist.get_world_size()))
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_device_type(),
                      torch.as_tensor(ranks).reshape(data_size, model_size),
                      mesh_dim_names=(data_axis, model_axis))


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Join ``num_processes`` processes into one group: this is process
    ``process_id``, and ``coordinator_address`` (``"host:port"`` or
    ``"tcp://host:port"``) is where process 0 listens. A no-op for one
    process or none, as in JAX (a later :func:`make_mesh` makes the
    world of one). Call it before any mesh is built. On CUDA each
    process takes card ``process_id % device_count``. The backend is
    NCCL for CUDA tensors (where a card is present) and gloo for CPU
    tensors."""
    if num_processes is None or num_processes <= 1:
        return
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = "tcp://" + addr
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(_backend(), init_method=addr,
                            world_size=num_processes, rank=process_id)


def axis_size(mesh, axis_name=DATA_AXIS):
    """Number of ranks along ``axis_name``."""
    if axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError("{!r} is not an axis of the mesh (axes: {})."
                         .format(axis_name, mesh.mesh_dim_names))
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def mesh_device(mesh):
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Sharding:
    """Placement of an array on a mesh: ``Shard(0)`` over ``axis_name``
    (each rank holds its contiguous block of axis 0) or ``Replicate()``
    (every rank holds it whole)."""

    def __init__(self, mesh, placement, axis_name=DATA_AXIS):
        self.mesh = mesh
        self.placement = placement
        self.axis_name = axis_name

    @property
    def is_shard(self):
        return self.placement.is_shard()

    @property
    def n_shards(self):
        return axis_size(self.mesh, self.axis_name) if self.is_shard else 1

    @property
    def index(self):
        """This rank's block on the sharding's axis (``axis_name``); 0
        where the sharding replicates."""
        return self.mesh.get_local_rank(self.axis_name) \
            if self.is_shard else 0

    @property
    def group(self):
        return self.mesh.get_group(self.axis_name)

    def block(self, rows):
        """This rank's ``[start, stop)`` of ``rows`` (which the axis
        divides)."""
        per = rows // self.n_shards
        return self.index * per, (self.index + 1) * per

    def __repr__(self):
        return "Sharding({}, {})".format(self.placement, self.axis_name)


def batch_sharding(mesh, ndim, axis_name=DATA_AXIS):
    """Shard axis 0 (the data axis) over ``axis_name``; ``ndim`` keeps
    JAX's signature (the placement names axis 0 whatever the rank)."""
    from torch.distributed.tensor import Shard
    return Sharding(mesh, Shard(0), axis_name)


def replicated_sharding(mesh):
    from torch.distributed.tensor import Replicate
    return Sharding(mesh, Replicate(), DATA_AXIS)


def data_shardings(mesh, arrays, axis_name=DATA_AXIS):
    """The placement :func:`shard_data` gives each array: its contiguous
    block of axis 0 on each rank when the ``axis_name`` axis size
    divides the leading dim, else the whole array on every rank."""
    n = axis_size(mesh, axis_name)
    return [batch_sharding(mesh, np.ndim(a), axis_name)
            if np.ndim(a) >= 1 and np.shape(a)[0] % n == 0
            else replicated_sharding(mesh) for a in arrays]


def shard_data(mesh, arrays, axis_name=DATA_AXIS):
    """This rank's part of each array, on its device, under
    :func:`data_shardings`: scalars and small side inputs whole. A
    LARGE array that falls back to replication defeats the data
    parallelism asked for, so that case warns, as in JAX: pad or trim
    the data to a multiple of the axis size to silence it. A sampler
    takes the parts with the placements (``create_sampling_executor(
    data_sharding=data_shardings(mesh, arrays))``)."""
    n = axis_size(mesh, axis_name)
    device = mesh_device(mesh)
    out = []
    for a, s in zip(arrays, data_shardings(mesh, arrays, axis_name)):
        shape = tuple(np.shape(a))
        if not s.is_shard and len(shape) >= 1 and shape[0] >= n:
            warnings.warn(
                "shard_data: array with leading dim {} does not "
                "divide the '{}' mesh axis (size {}); REPLICATING "
                "it on every device — the step stays correct but "
                "this input is not data-parallel. Pad or trim to "
                "a multiple of {} to shard it.".format(
                    shape[0], axis_name, n, n), RuntimeWarning)
        t = torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a))
        if s.is_shard:
            lo, hi = s.block(shape[0])
            t = t[lo:hi]
        out.append(t.to(device).contiguous())
    return out


def device_put(a, sharding):
    """``a`` placed on this rank under ``sharding``: the counterpart of
    ``jax.device_put(a, NamedSharding(mesh, spec))``.

    A sharding that shards (``batch_sharding(mesh, a.ndim, "model")``, or
    ``Sharding(mesh, Shard(0), "model")``) gives a
    :class:`torch.distributed.tensor.DTensor` on the mesh, ``Shard(0)``
    on the sharding's axis and ``Replicate()`` on every other, whose
    local tensor is this rank's contiguous block of axis 0 on its
    device. Axis 0 must divide by the axis size: otherwise ValueError,
    as in JAX. A replicated sharding gives the whole tensor on this
    rank's device. A DTensor ``a`` is gathered whole first."""
    t = whole(a).detach() if is_sharded(a) else torch.as_tensor(
        a if torch.is_tensor(a) else np.asarray(a))
    device = mesh_device(sharding.mesh)
    if not sharding.is_shard:
        return t.to(device).contiguous()
    n = sharding.n_shards
    if t.ndim == 0:
        raise ValueError("device_put: a 0-d array has no axis 0 to shard "
                         "over '{}': replicate it (replicated_sharding("
                         "mesh)).".format(sharding.axis_name))
    if t.shape[0] % n:
        raise ValueError(
            "device_put: the sharding {} of an array of shape {} implies "
            "that the global size of its dimension 0 should be divisible "
            "by {}, but it is equal to {}. Pad or trim axis 0 to a "
            "multiple of {}, or replicate the array "
            "(replicated_sharding(mesh)).".format(
                sharding, tuple(t.shape), n, t.shape[0], n))
    from torch.distributed.tensor import DTensor, Replicate, Shard
    lo, hi = sharding.block(t.shape[0])
    placements = [Shard(0) if name == sharding.axis_name else Replicate()
                  for name in sharding.mesh.mesh_dim_names]
    full = t.contiguous()
    return DTensor.from_local(t[lo:hi].to(device).contiguous(),
                              sharding.mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def all_gather(t, group, n, dim=0):
    """Every rank's ``t`` of the ``n``-rank ``group``, concatenated along
    ``dim`` in rank order."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def replicate_tree(mesh, tree):
    """The tree's tensors on this rank's device, equal on every rank:
    broadcast from the mesh's first rank (so ranks that initialized
    differently start alike). A parameter placed over an axis is
    gathered whole first, as JAX's replicated ``device_put`` gathers
    it."""
    device = mesh_device(mesh)
    src = int(mesh.mesh.flatten()[0])

    def bcast(a):
        a = whole(a).detach() if is_sharded(a) else a
        t = torch.as_tensor(a).to(device).contiguous()
        if dist.get_world_size() > 1:
            dist.broadcast(t, src=src)
        return t
    return pytree.tree_map(bcast, tree)
