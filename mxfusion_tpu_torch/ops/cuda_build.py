"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each ``csrc/*.cu`` file exports a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) on first use, into
``build/mxfusion_tpu_torch/`` beside the package (a directory git
ignores), under a name keyed by a hash of the source and the flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "mxfusion_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED = {}
_LOCK = threading.Lock()


def find_nvcc():
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``. Raises when there is none."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / \
            "bin" / "nvcc"
        if cand.is_file():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH, $CUDA_HOME and "
            "/usr/local/cuda): the CUDA kernels are built from "
            "mxfusion_tpu_torch/csrc on first use and need the CUDA "
            "toolkit.")
    return nvcc


def library_path(source):
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / "{}-{}.so".format(src.stem, digest)


def build(source):
    """Compile ``csrc/<source>`` unless its library exists; return the
    library's path. nvcc's output (with ``-Xptxas -v``: registers,
    shared memory and spills of each kernel) is kept beside it as
    ``.log``. Raises with nvcc's stderr when the compile fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("{}.{}.tmp".format(out.name, os.getpid()))
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed to build {} (exit {}):\n{}"
                               .format(source, proc.returncode,
                                       proc.stderr))
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def load(source):
    """Build (if needed) and load ``csrc/<source>``; one handle per
    process."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _LOADED[source] = lib
        return lib
