"""Serialization helpers.

Counterpart of ``mxfusion_tpu/util/serialization.py``, kept byte for
byte in its layout so that a zip saved by either package loads in the
other: a zip of six entries (version, graph skeletons, parameter
arrays, array constants, primitive constants, configuration), the
arrays stored as an embedded npz. Nothing is pickled.
"""
import io

import numpy as np

SERIALIZATION_VERSION = "1.0"
GRAPH_JSON_VERSION = "1.0"

FILENAMES = {
    "version": "version.json",
    "graphs": "graphs.json",
    "params": "parameters.npz",
    "array_constants": "array_constants.npz",
    "prim_constants": "variable_constants.json",
    "configuration": "configuration.json",
}


def make_numpy_zip_bytes(arrays):
    """Serialize {name: np array} to npz bytes."""
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def read_numpy_zip_bytes(data):
    """Inverse of :func:`make_numpy_zip_bytes`."""
    buf = io.BytesIO(data)
    loaded = np.load(buf, allow_pickle=False)
    return {k: loaded[k] for k in loaded.files}
