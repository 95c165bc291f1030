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

AOT export (``export``/``load_exported_predictor``) and the mesh-sharded
path come later.
"""
import torch
from torch.utils import _pytree as pytree

from .inference import TransferInference
from .inference_alg import create_sampling_executor, as_runtime_tensor
from .prediction import ModulePredictionAlgorithm
from ..common.exceptions import ModelSpecificationError


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


def _chunked_predict(call, C, data, generator, output_spec=None):
    """Shared chunk/pad/merge loop.

    ``call(chunk_list, generator)`` returns the output pytree for one
    C-row chunk. ``output_spec``: optional per-flattened-leaf tuples of
    data-axis indices (see :func:`_leaf_data_axes`). Returns the merged
    pytree with numpy leaves."""
    N = data[0].shape[0]
    if N == 0:
        raise ValueError(
            "predict() called with zero rows; chunked serving needs at "
            "least one input row.")
    chunks = []      # (pad, flat leaves) per chunk
    treedef = None
    for i in range(0, N, C):
        chunk = [d[i:i + C] for d in data]
        pad = C - chunk[0].shape[0]
        if pad:
            chunk = [_pad_chunk(c, C) for c in chunk]
        leaves, treedef = pytree.tree_flatten(call(chunk, generator))
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
                 chunk_size=1024, num_samples=None, output_spec=None):
        """``infr_params``: the trained ``InferenceParameters`` (or an
        ``Inference``); the predictor serves on its dtype and device.
        ``output_spec``: optional explicit data-axis declaration, one
        tuple of axis indices per flattened output leaf. ``num_samples``:
        sample count handed to the prediction algorithm (``None`` =
        unset, read as 1 by moment-based algorithms)."""
        self.chunk_size = chunk_size
        self.output_spec = output_spec
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
        self._infr.initialize(
            **{n: d[:self._chunk] for n, d in zip(names, data)})
        self._executor = create_sampling_executor(
            self._infr.inference_algorithm, self._infr.params)
        if self.output_spec is None:
            self.output_spec = self._declared_output_spec()

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
        names = self._infr.observed_variable_names
        params = self._infr.params
        with torch.no_grad():
            data = [as_runtime_tensor(kwargs[n], params.dtype,
                                      params.device) for n in names]
            if data[0].shape[0] == 0:
                raise ValueError(
                    "zero input rows; chunked serving needs at least one "
                    "row to fix the chunk shapes.")
            if self._executor is None:
                self._build(names, data)
            if generator is None:
                generator = torch.Generator(
                    device=params.device).manual_seed(0)
            trainable = params.trainable_params()
            fixed = params.fixed_params()
            return _chunked_predict(
                lambda chunk, g: self._executor(trainable, fixed, chunk, g),
                self._chunk, data, generator, output_spec=self.output_spec)
