"""ctypes loader for the native batcher (lazy build, numpy fallback).

Counterpart of ``mxfusion_tpu/native/loader.py``, with its own copy of
``fast_batcher.cpp``. The shared library is built on first use with the
system C++ compiler into ``build/native/`` under the repository root (a
directory git ignores), and rebuilt when the source is newer than it.
Any failure (no compiler, a read-only tree) falls back to numpy, the
JAX loader's rule: so on a host where one package's batcher builds, the
other's does too, and both shuffle an epoch alike.
"""
import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = Path(__file__).resolve().parent / "fast_batcher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"


def _build_and_load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            lib_path = BUILD_DIR / "libfastbatcher.so"
            if not lib_path.exists() or \
                    lib_path.stat().st_mtime < _SRC.stat().st_mtime:
                # a per-process name, so builds that race end in one
                # whole library
                tmp = lib_path.with_suffix(".so.{}".format(os.getpid()))
                subprocess.run(
                    ["c++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-o", str(tmp), str(_SRC), "-lpthread"],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            lib.gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int]
            lib.shuffled_indices.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_uint64]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def native_available():
    """Whether the native library built and loaded."""
    return _build_and_load() is not None


def gather_rows(src, idx, out=None, n_threads=8):
    """``out[i] = src[idx[i]]`` over axis 0 (native when available).
    ``out`` may be any C-contiguous array of the right shape and dtype,
    e.g. a numpy view of a pinned host tensor."""
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    # bounds checked up front: the native path is a raw memcpy loop and
    # must fail as the numpy fallback does (IndexError)
    if idx.size and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError(
            "gather_rows: index out of range for axis 0 with size {}"
            .format(src.shape[0]))
    n = idx.shape[0]
    if out is None:
        out = np.empty((n,) + src.shape[1:], dtype=src.dtype)
    lib = _build_and_load()
    if lib is None:
        out[...] = src[idx]
        return out
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                 dtype=np.int64))
    lib.gather_rows(
        src.ctypes.data_as(ctypes.c_void_p),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n), ctypes.c_int64(row_bytes),
        ctypes.c_int(n_threads))
    return out


def shuffled_indices(n, seed):
    """Fisher-Yates permutation of [0, n) (native when available: the
    splitmix64 stream of ``fast_batcher.cpp``; numpy's
    ``default_rng(seed).permutation(n)`` otherwise)."""
    lib = _build_and_load()
    if lib is None:
        return np.random.default_rng(seed).permutation(n)
    idx = np.empty(n, dtype=np.int64)
    lib.shuffled_indices(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n), ctypes.c_uint64(seed))
    return idx
