"""Serving-oriented batched prediction.

Counterpart of ``mxfusion_tpu/inference/serving.py``.
``BatchedPredictor`` fixes a chunk size at the first request and streams
requests of any length through the prediction executor chunk by chunk:
the tail chunk is padded by repeating its last row and the padding is
stripped from the outputs. The JAX package compiles the executor once
at that chunk shape; PyTorch runs eagerly, so here the executor is
built once and every chunk keeps the same shapes (the ground a later
CUDA-graph capture stands on). A request is moved to the device once,
chunked and merged there, and returned as numpy arrays.

``BatchedPredictor.export(path)`` captures the per-chunk call with
``torch.export`` and writes it beside a parameter snapshot;
``load_exported_predictor(path)`` serves it without the
model-definition code or a graph rebuild, needing only this package
(which registers the operators the program calls: K1's launch and the
tiered products, each carrying its precision). The program's inputs are
the parameters, the buffers of the graph's networks, the chunk and the
chunk's base draws (``random_gen.base_draw``): a prediction that draws
is served by drawing those inputs from the caller's generator, with the
calls the live predictor makes, so that on the same generator state the
artifact returns the live predictor's draws and outputs.

Over a mesh (``mesh=``, one process per device, ``parallel``), both
predictors deal whole chunks to the ranks round-robin and all-gather
each round's outputs, so every rank returns the whole answer, full
covariances included. A prediction that draws random numbers draws on
each rank from a stream of its own, the first rank's being the caller's
generator: the draws differ from one process's in value, not in
distribution. A mesh predictor is not exported, as in JAX: export an
unsharded one and pass the mesh to ``load_exported_predictor``.

Both predictors run each chunk at IEEE float32 for every product that
carries no tier of its own (the triangular solves and the Cholesky,
whose cuBLAS/cuSOLVER calls follow ``torch.set_float32_matmul_precision``,
and a network's layers), so that what a request returns does not depend
on the precision the serving process has set; an artifact records that
precision in its ``meta.json``.
"""
import contextlib
import io
import json
import zipfile

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .inference import TransferInference
from .inference_alg import create_sampling_executor, as_runtime_tensor
from .prediction import ModulePredictionAlgorithm
from ..common.config import resolve_device
from ..common.exceptions import ModelSpecificationError
from ..components.distributions import random_gen
# the operators an exported program calls, registered on import
from ..ops import cuda_kernels, precision  # noqa: F401

# torch-1.1 adds the networks' buffers and the base draws as program
# inputs; a torch-1.0 program takes (trainable, fixed, chunk)
FORMAT_VERSION = "torch-1.1"
_READABLE_VERSIONS = ("torch-1.0", FORMAT_VERSION)
# the float32 matmul precision every untiered product of a chunk runs at
_SERVING_PRECISION = "highest"


def _leaf_data_axes(shape, C, spec=None):
    """Data axes of one output leaf of ``shape`` for chunk size ``C``.

    ``spec`` (a tuple/list of axis indices, from the caller's
    ``output_spec``) overrides the inference. Inferred cases:

    * exactly one axis of size C              -> concatenate there
    * anything else (including a trailing (C, C) pair, which is either
      a full covariance or (rows, features) with features == C)
                                              -> ambiguous; raise and
      ask for an explicit ``output_spec``
    """
    if spec is not None:
        return tuple(ax % len(shape) for ax in spec)
    hits = [i for i, s in enumerate(shape) if s == C]
    if len(hits) == 1:
        return (hits[0],)
    raise ValueError(
        "cannot infer the data axes of output leaf shape {} at chunk "
        "size {} ({} axes match); pass output_spec=[...] with one "
        "tuple of data-axis indices per flattened output leaf (e.g. "
        "[(1,), (1, 2)] for a (s, C, D) mean and a (s, C, C) full "
        "covariance).".format(tuple(shape), C, len(hits)))


class _DerivedSpec(list):
    """An output_spec derived from a module's declared
    ``serving_data_axes`` (vs user-supplied): on a leaf-count mismatch
    the merge quietly falls back to per-leaf inference instead of
    raising, since the user never wrote it."""


def _pad_chunk(c, C):
    """Pad a short chunk to exactly C rows by repeating the last row
    (stripped from the outputs by the merge)."""
    pad = C - c.shape[0]
    if pad:
        c = torch.cat([c, c[-1:].expand((pad,) + tuple(c.shape[1:]))])
    return c


def _merge_leaf(pieces_with_pad, axes, C, N):
    """Merge per-chunk tensors into the full-N output.

    One data axis: strip padding and concatenate. Two data axes (full
    predictive covariance): assemble the BLOCK-DIAGONAL (..., N, N)
    covariance — each chunk contributes its own (C, C) block and
    cross-chunk covariances are zero (they are never computed)."""
    if len(axes) == 1:
        ax = axes[0]
        pieces = [x.narrow(ax, 0, C - pad) if pad else x
                  for pad, x in pieces_with_pad]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=ax)
    ax0, ax1 = axes
    first = pieces_with_pad[0][1]
    out_shape = list(first.shape)
    out_shape[ax0] = N
    out_shape[ax1] = N
    out = first.new_zeros(out_shape)
    off = 0
    for pad, x in pieces_with_pad:
        rows = C - pad
        idx = [slice(None)] * out.ndim
        idx[ax0] = slice(off, off + rows)
        idx[ax1] = slice(off, off + rows)
        blk = [slice(None)] * x.ndim
        blk[ax0] = slice(0, rows)
        blk[ax1] = slice(0, rows)
        out[tuple(idx)] = x[tuple(blk)]
        off += rows
    return out


def _chunked_predict(call, C, data, generator, output_spec=None,
                     run_chunks=None):
    """Shared chunk/pad/merge loop.

    ``call(chunk_list, generator)`` returns the output pytree for one
    C-row chunk; ``run_chunks(chunks)``, when given, returns the list of
    every chunk's instead. ``output_spec``: optional per-flattened-leaf
    tuples of data-axis indices (see :func:`_leaf_data_axes`). Returns
    the merged pytree with numpy leaves."""
    N = data[0].shape[0]
    if N == 0:
        raise ValueError(
            "predict() called with zero rows; chunked serving needs at "
            "least one input row.")
    pads, inputs = [], []
    for i in range(0, N, C):
        chunk = [d[i:i + C] for d in data]
        pad = C - chunk[0].shape[0]
        if pad:
            chunk = [_pad_chunk(c, C) for c in chunk]
        pads.append(pad)
        inputs.append(chunk)
    outs = run_chunks(inputs) if run_chunks is not None else \
        (call(chunk, generator) for chunk in inputs)
    chunks = []      # (pad, flat leaves) per chunk
    treedef = None
    for pad, out in zip(pads, outs):
        leaves, treedef = pytree.tree_flatten(out)
        chunks.append((pad, leaves))

    first = chunks[0][1]
    if output_spec is not None and len(output_spec) != len(first):
        if isinstance(output_spec, _DerivedSpec):
            output_spec = None  # derived guess wrong: infer per leaf
        else:
            raise ValueError(
                "output_spec has {} entries but the prediction has {} "
                "output leaves.".format(len(output_spec), len(first)))
    merged = []
    for j, x0 in enumerate(first):
        spec = output_spec[j] if output_spec is not None else None
        if spec is not None and isinstance(output_spec, _DerivedSpec):
            # a DERIVED spec is a structural guess: trust it only where
            # every declared data axis of the leaf has size C
            ok = all(-x0.ndim <= ax < x0.ndim
                     and x0.shape[ax % x0.ndim] == C for ax in spec)
            if not ok:
                spec = None
        axes = _leaf_data_axes(x0.shape, C, spec)
        merged.append(_merge_leaf(
            [(pad, leaves[j]) for pad, leaves in chunks], axes, C,
            N).cpu().numpy())
    return pytree.tree_unflatten(merged, treedef)


class BatchedPredictor:
    """Fixed-shape chunked prediction over a trained model.

    Diagonal-variance outputs concatenate on their data axis; FULL
    predictive covariances (two data axes, e.g. a (s, C, C) leaf) merge
    block-diagonally across chunks. Axes come from the module's declared
    ``serving_data_axes``, are inferred per leaf, or are declared with
    ``output_spec``.

    Example::

        pred = BatchedPredictor(model=m, infr_params=params,
                                observed=[m.X], chunk_size=8192,
                                target_variables=[m.Y.uuid])
        mu, var = pred.predict(X=X_test)[0]
    """

    def __init__(self, model, infr_params, observed, target_variables=None,
                 chunk_size=1024, num_samples=None, output_spec=None,
                 mesh=None, data_axis=None):
        """``infr_params``: the trained ``InferenceParameters`` (or an
        ``Inference``); the predictor serves on its dtype and device.
        ``output_spec``: optional explicit data-axis declaration, one
        tuple of axis indices per flattened output leaf. ``num_samples``:
        sample count handed to the prediction algorithm (``None`` =
        unset, read as 1 by moment-based algorithms).

        ``mesh``: a ``parallel`` mesh; the chunks are then dealt to the
        ranks of ``data_axis`` (default: the mesh's first axis), each
        predicting with the parameters it holds, and their outputs are
        all-gathered (see the module docstring). ``chunk_size`` must
        divide by the axis size, as in JAX."""
        self.chunk_size = chunk_size
        self.output_spec = output_spec
        self._mesh = mesh
        if mesh is not None:
            self._data_axis = _resolve_mesh_serving(mesh, data_axis,
                                                    chunk_size)
        alg = ModulePredictionAlgorithm(
            model=model, observed=observed,
            target_variables=target_variables, num_samples=num_samples)
        self._infr = TransferInference(alg, infr_params=infr_params)
        self._executor = None
        self._chunk = None

    def _build(self, names, data):
        """Fix the chunk size from the first request and build the
        executor (the counterpart of the JAX package's compile)."""
        self._chunk = min(self.chunk_size, data[0].shape[0])
        chunk0 = [d[:self._chunk] for d in data]
        self._infr.initialize(**dict(zip(names, chunk0)))
        self._executor = create_sampling_executor(
            self._infr.inference_algorithm, self._infr.params)
        self._chunk_specs = [(tuple(c.shape), c.dtype) for c in chunk0]
        if self.output_spec is None:
            self.output_spec = self._declared_output_spec()

    def _request(self, kwargs):
        """The named inputs as tensors of the store's dtype on its
        device; builds the executor at the first request."""
        names = self._infr.observed_variable_names
        params = self._infr.params
        data = [as_runtime_tensor(kwargs[n], params.dtype, params.device)
                for n in names]
        if data[0].shape[0] == 0:
            raise ValueError(
                "zero input rows; chunked serving needs at least one "
                "row to fix the chunk shapes.")
        if self._executor is None:
            self._build(names, data)
        return data

    def _declared_output_spec(self):
        """The module prediction algorithm's declared
        ``serving_data_axes``, when the targets are the outputs of a
        single module; None otherwise (per-leaf inference)."""
        from ..modules.module import Module
        alg = self._infr.inference_algorithm
        targets = alg.target_variables
        modules = [f for f in alg.model.ordered_factors
                   if isinstance(f, Module)]
        if len(modules) != 1:
            return None
        mod = modules[0]
        mod_targets = [v.uuid for _, v in mod.outputs]
        if targets is not None and set(targets) != set(mod_targets):
            return None
        env = {v.uuid: None for _, v in mod.inputs}
        try:
            mod_alg = mod._get_algorithm(
                mod._prediction_algorithms, mod_targets, env,
                exact_match=True)
        except ModelSpecificationError:
            return None
        axes = mod_alg.serving_data_axes
        if axes is None:
            return None
        return _DerivedSpec(tuple(axes) * len(mod_targets))

    def predict(self, generator=None, **kwargs):
        """Predict for the named observed inputs (numpy arrays or
        tensors, any leading-axis length). Returns the prediction
        algorithm's structure (tuples of (mean, variance) per target by
        default) with numpy leaves, chunk results concatenated on the
        data axis. ``generator``: the ``torch.Generator`` for any random
        draws (default: seeded with 0 on the serving device)."""
        params = self._infr.params
        with torch.no_grad():
            data = self._request(kwargs)
            if generator is None:
                generator = torch.Generator(
                    device=params.device).manual_seed(0)
            trainable = params.trainable_params()
            fixed = params.fixed_params()

            def call(chunk, g):
                return self._executor(trainable, fixed, chunk, g)
            run_chunks = None
            if self._mesh is not None:
                g = _rank_generator(
                    generator, self._mesh.get_local_rank(self._data_axis))
                run_chunks = _dealt_chunks(lambda chunk: call(chunk, g),
                                           self._mesh, self._data_axis)
            with precision._matmul_precision(_SERVING_PRECISION):
                return _chunked_predict(call, self._chunk, data, generator,
                                        output_spec=self.output_spec,
                                        run_chunks=run_chunks)

    # ------------------------------------------------------------------
    def export(self, path, **example_data):
        """Write the per-chunk prediction program and a parameter
        snapshot to ``path`` (a zip of ``program.pt2``, ``params.npz``
        and ``meta.json``). Before the first ``predict``,
        ``example_data`` (the same keyword arguments) fixes the chunk
        shapes.

        The program is ``torch.export`` of ``executor(trainable, fixed,
        chunk)`` with the parameters, the buffers of every
        ``NNFunction`` of the graph (under their names, ``f_bn_running_mean``)
        and the chunk's base draws as program inputs. It is traced on
        the store's device and runs only there, with every untiered
        product, the networks' included, at IEEE float32 as in
        ``predict``; two networks whose buffers share a name raise. A
        draw of the prediction's random generators is
        recorded as an input; a gamma or Poisson draw, which has no
        parameter-free base, raises. So does a draw that bypasses the
        generators, such as a network's ``Dropout`` in training mode
        (put the network in eval mode), and so does a mesh predictor,
        as in JAX (the program would be pinned to this mesh): export an
        unsharded predictor and pass the mesh to
        ``load_exported_predictor``."""
        if self._mesh is not None:
            raise ValueError(
                "export() of a mesh-sharded predictor is not supported: "
                "the exported program would be pinned to this mesh. "
                "Export an unsharded BatchedPredictor and shard at load "
                "time instead.")
        params = self._infr.params
        nets = _networks(self._infr.inference_algorithm.model)
        with torch.no_grad():
            if self._executor is None:
                if not example_data:
                    raise ValueError(
                        "export() before the first predict(): pass example "
                        "data kwargs to fix the chunk shapes.")
                self._request(example_data)
            trainable = {k: v.detach()
                         for k, v in params.trainable_params().items()}
            fixed = {k: v.detach()
                     for k, v in params.fixed_params().items()}
            buffers = {}
            for net in nets:
                for k, v in net.held_buffers().items():
                    if k in buffers:
                        raise ValueError(
                            "two networks of the graph hold a buffer named "
                            "{!r}, and the artifact keeps buffers by name: "
                            "give their NNFunctions different names."
                            .format(k))
                    buffers[k] = v.detach()
            chunk0 = [torch.zeros(shape, dtype=dtype, device=params.device)
                      for shape, dtype in self._chunk_specs]
            generator = torch.Generator(device=params.device).manual_seed(0)
            with random_gen.drawing_from(random_gen.DrawRecorder()) as rec, \
                    precision._matmul_precision(_SERVING_PRECISION):
                self._executor(trainable, fixed, chunk0, generator)
            program = torch.export.export(
                _ChunkProgram(self._executor, generator, nets),
                (trainable, fixed, buffers, chunk0, rec.values))
        _refuse_seeded_ops(program)
        # to the ATen IR: a network's vmap over the samples leaves
        # functorch calls in the traced graph that the serializer of some
        # torch versions refuses; the package's operators stay as they are
        program = program.run_decompositions({})
        # the parameters travel in params.npz, the chunk is zeros and the
        # draws are drawn anew: keep the example inputs out of program.pt2
        program.example_inputs = None
        program_bytes = io.BytesIO()
        torch.export.save(program, program_bytes)
        arrays = {"t::" + k: v.cpu().numpy() for k, v in trainable.items()}
        arrays.update({"f::" + k: v.cpu().numpy() for k, v in fixed.items()})
        arrays.update({"b::" + k: v.cpu().numpy() for k, v in buffers.items()})
        arrays_bytes = io.BytesIO()
        np.savez(arrays_bytes, **arrays)
        meta = {"names": list(self._infr.observed_variable_names),
                "chunk": int(self._chunk),
                "input_dtypes": [_dtype_name(dt)
                                 for _, dt in self._chunk_specs],
                "device": params.device.type,
                "output_spec": ([list(t) for t in self.output_spec]
                                if self.output_spec is not None else None),
                # a spec derived from serving_data_axes is a structural
                # guess: the loader restores its soft, per-leaf-validated
                # semantics instead of treating it as a user declaration
                "output_spec_derived": isinstance(self.output_spec,
                                                  _DerivedSpec),
                "buffers": list(buffers),
                "draws": [{"kind": kind, "shape": list(shape),
                           "dtype": _dtype_name(dt)}
                          for kind, shape, dt in rec.specs],
                "matmul_precision": _SERVING_PRECISION,
                "format_version": FORMAT_VERSION}
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("program.pt2", program_bytes.getvalue())
            zf.writestr("params.npz", arrays_bytes.getvalue())
            zf.writestr("meta.json", json.dumps(meta))
        return path


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _networks(model):
    """The ``NNFunction``s of ``model``'s graph, each once, in factor
    order."""
    from ..components.functions import NNFunction
    nets = []
    for f in model.ordered_factors:
        net = getattr(f, "function", None)
        if isinstance(net, NNFunction) and all(net is not n for n in nets):
            nets.append(net)
    return nets


def _argument(node, name):
    """The value of the operator argument ``name`` at ``node``, or None
    (a dropout in eval mode is a traced ``dropout(x, p, train=False)``,
    which draws nothing)."""
    schema = getattr(node.target, "_schema", None)
    for i, arg in enumerate(schema.arguments if schema else ()):
        if arg.name == name:
            if i < len(node.args):
                return node.args[i]
            return node.kwargs.get(name, arg.default_value)
    return None


def _refuse_seeded_ops(program):
    """Raise if the traced program draws random numbers itself: every
    draw of a served chunk must be one of its inputs."""
    seeded = sorted({str(n.target) for n in program.graph.nodes
                     if n.op == "call_function"
                     and torch.Tag.nondeterministic_seeded in
                     getattr(n.target, "tags", ())
                     and _argument(n, "train") is not False})
    if seeded:
        raise NotImplementedError(
            "export() of a prediction that draws random numbers outside "
            "the package's random generators is not supported (the "
            "program calls {}; a network's Dropout in training mode does "
            "this: put the network in eval mode). Serve it through "
            "BatchedPredictor.predict.".format(", ".join(seeded)))


def _axis_size(mesh, axis):
    from ..parallel.mesh import axis_size
    return axis_size(mesh, axis)


def _resolve_mesh_serving(mesh, data_axis, chunk):
    """Validate a sharded-serving request; returns the data axis name
    (JAX's checks: the axis exists, the chunk divides it)."""
    axis = data_axis if data_axis is not None else mesh.mesh_dim_names[0]
    if axis not in mesh.mesh_dim_names:
        raise ValueError(
            "data_axis {!r} is not an axis of the mesh (axes: {})."
            .format(axis, tuple(mesh.mesh_dim_names)))
    n_shards = _axis_size(mesh, axis)
    if chunk % n_shards:
        raise ValueError(
            "chunk size ({}) must be divisible by the '{}' mesh axis "
            "size ({}) for sharded serving.".format(chunk, axis, n_shards))
    return axis


def _rank_generator(generator, index):
    """The generator rank ``index`` draws its chunks from: the caller's
    on the first rank, so a world of one draws as one process does; on
    the others one seeded from a copy of it and the index, so no two
    ranks draw alike."""
    if index == 0:
        return generator
    copy = torch.Generator(device=generator.device)
    copy.set_state(generator.get_state())
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=copy,
                             device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(seed + index)


def _dealt_chunks(call, mesh, axis):
    """``run_chunks`` over a mesh: each rank runs ``call(chunk)`` on whole
    chunks, dealt round-robin, and every round's outputs are
    all-gathered; returns the outputs of the chunks in order."""
    import torch.distributed as dist
    n = _axis_size(mesh, axis)
    index = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)

    def run_chunks(chunks):
        # every rank runs as many chunks: repeat the last to fill a round
        padded = chunks + [chunks[-1]] * (-len(chunks) % n)
        outs = []
        for start in range(0, len(padded), n):
            leaves, treedef = pytree.tree_flatten(call(padded[start + index]))
            parts = []
            for x in leaves:
                parts.append([torch.empty_like(x) for _ in range(n)])
                dist.all_gather(parts[-1], x.contiguous(), group=group)
            outs.extend(pytree.tree_unflatten([p[r] for p in parts],
                                              treedef) for r in range(n))
        return outs[:len(chunks)]
    return run_chunks


class _ChunkProgram(torch.nn.Module):
    """The per-chunk call ``torch.export`` traces: the networks evaluate
    with the buffers given, and every base draw is the next of
    ``draws`` (the generator is never drawn from)."""

    def __init__(self, executor, generator, nets):
        super().__init__()
        self.executor = executor
        self.generator = generator
        self.nets = nets

    def forward(self, trainable, fixed, buffers, chunk, draws):
        with contextlib.ExitStack() as stack:
            for net in self.nets:
                stack.enter_context(net.buffers_bound(buffers))
            stack.enter_context(random_gen.drawing_from(
                random_gen.DrawReplay(draws)))
            return self.executor(trainable, fixed, chunk, self.generator)


class ExportedPredictor:
    """Serves a ``BatchedPredictor.export`` artifact: the same
    ``predict`` contract, no model rebuild, no graph machinery."""

    def __init__(self, program, trainable, fixed, names, chunk, dtypes,
                 device, output_spec=None, mesh=None, data_axis=None,
                 buffers=None, draws=(), legacy=False):
        """``buffers``: the networks' buffers by name; ``draws``: the
        (kind, shape, dtype) of each base draw of a chunk, in order;
        ``legacy``: a torch-1.0 program, called as (trainable, fixed,
        chunk)."""
        self._program = program
        self._call = program.module()
        self._trainable = trainable
        self._fixed = fixed
        self._buffers = buffers or {}
        self._draws = list(draws)
        self._legacy = legacy
        self._names = names
        self._chunk = chunk
        self._dtypes = dtypes
        self._device = device
        self._output_spec = output_spec
        self._mesh = mesh
        if mesh is not None:
            self._data_axis = _resolve_mesh_serving(mesh, data_axis, chunk)

    def _run(self, chunk, generator):
        if self._legacy:
            return self._call(self._trainable, self._fixed, chunk)
        return self._call(self._trainable, self._fixed, self._buffers,
                          chunk, random_gen.draw_inputs(self._draws,
                                                        generator))

    def predict(self, generator=None, **kwargs):
        """Predict for the named inputs (numpy arrays or tensors, any
        leading-axis length, cast to the dtypes the program was traced
        with); numpy leaves, as ``BatchedPredictor.predict``.
        ``generator``: the ``torch.Generator`` each chunk's draws come
        from (default: seeded with 0 on the serving device), as the live
        predictor's; over a mesh, each rank but the first draws from a
        stream of its own. A prediction that does not draw ignores it."""
        with torch.no_grad():
            data = [torch.as_tensor(kwargs[n], device=self._device).to(dt)
                    for n, dt in zip(self._names, self._dtypes)]
            if generator is None:
                generator = torch.Generator(
                    device=self._device).manual_seed(0)
            run_chunks = None
            if self._mesh is not None:
                g = _rank_generator(
                    generator, self._mesh.get_local_rank(self._data_axis))
                run_chunks = _dealt_chunks(lambda chunk: self._run(chunk, g),
                                           self._mesh, self._data_axis)
            with precision._matmul_precision(_SERVING_PRECISION):
                return _chunked_predict(self._run, self._chunk, data,
                                        generator,
                                        output_spec=self._output_spec,
                                        run_chunks=run_chunks)


def load_exported_predictor(path, device=None, mesh=None, data_axis=None):
    """Load a ``BatchedPredictor.export`` artifact (format torch-1.1, or
    torch-1.0 as written before the buffers and draws became program
    inputs) to serve on ``device`` (default: the package's default
    device; under a mesh, this rank's), which must be of the type it was
    traced on. A JAX package artifact (``function.bin``) raises: it is
    StableHLO, which this package does not run. ``mesh``: serve over a
    ``parallel`` mesh, whole chunks dealt to the ranks of ``data_axis``
    (default: the first axis) and their outputs all-gathered; the chunk
    must divide by the axis size, as in JAX."""
    if mesh is not None and device is None:
        from ..parallel.mesh import mesh_device
        device = mesh_device(mesh)
    device = resolve_device(device)
    with zipfile.ZipFile(path) as zf:
        if "function.bin" in zf.namelist():
            raise ValueError(
                "{} is an artifact of the JAX package (jax.export, "
                "function.bin), which mxfusion_tpu_torch cannot serve; "
                "export the predictor with mxfusion_tpu_torch's "
                "BatchedPredictor.export.".format(path))
        meta = json.loads(zf.read("meta.json"))
        version = meta.get("format_version")
        if version not in _READABLE_VERSIONS or meta.get(
                "matmul_precision", _SERVING_PRECISION) != _SERVING_PRECISION:
            raise ValueError("unsupported predictor artifact version: {} "
                             "(matmul precision {})".format(
                                 version, meta.get("matmul_precision")))
        if meta["device"] != device.type:
            raise ValueError(
                "the artifact was traced on {} and cannot be served on {}: "
                "export it from a predictor whose parameters live on {}."
                .format(meta["device"], device, device.type))
        program = torch.export.load(io.BytesIO(zf.read("program.pt2")))
        arrays = np.load(io.BytesIO(zf.read("params.npz")),
                         allow_pickle=False)
        stored = {prefix: {k[3:]: torch.as_tensor(arrays[k], device=device)
                           for k in arrays.files if k.startswith(prefix)}
                  for prefix in ("t::", "f::", "b::")}
    spec = [tuple(t) for t in meta["output_spec"]] \
        if meta.get("output_spec") else None
    if spec is not None and meta.get("output_spec_derived"):
        spec = _DerivedSpec(spec)
    draws = [(d["kind"], tuple(d["shape"]), getattr(torch, d["dtype"]))
             for d in meta.get("draws", ())]
    return ExportedPredictor(
        program, stored["t::"], stored["f::"], meta["names"], meta["chunk"],
        [getattr(torch, d) for d in meta["input_dtypes"]], device,
        output_spec=spec, mesh=mesh, data_axis=data_axis,
        buffers=stored["b::"], draws=draws, legacy=version == "torch-1.0")
