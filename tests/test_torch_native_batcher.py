"""The port's native batcher (``mxfusion_tpu_torch.native``) against the
JAX package's, and the host minibatch loop's batches and trajectory
against JAX's on the native path.

Both packages build the same ``fast_batcher.cpp`` (the port keeps its own
copy) and choose native or numpy by the same rule, so on a host with a
C++ compiler both shuffle an epoch with the splitmix64 Fisher-Yates, and
the port's minibatch loop takes JAX's batches without any patch
(``tests/test_torch_svgp_training.py`` keeps the forced-fallback case).

``jax_native_ready`` makes JAX's loader native in the calling process
whatever ran earlier in it (fault C4: JAX's loader builds through one
shared temporary name and remembers a failed try for the life of the
process, so workers that make their first call together fall back to
numpy for good). The tests that hold the port to JAX natively take the
``both_native`` fixture, which fails where a C++ compiler exists and a
loader still falls back, and skips only where there is no compiler.
"""
import fcntl
import os
import shutil
import subprocess
import tempfile

import jax
import numpy as np
import pytest

from mxfusion_tpu.native import loader as jloader
from mxfusion_tpu.inference import MinibatchInferenceLoop as JMinibatch
from mxfusion_tpu_torch.native import (gather_rows, loader, native_available,
                                       shuffled_indices)
from mxfusion_tpu_torch.inference import MinibatchInferenceLoop
from mxfusion_tpu_torch.common import config as tconfig

from tests.test_torch_svgp_training import _by_path, _data, _pair, jax_f64



def jax_native_ready(monkeypatch):
    """Make ``mxfusion_tpu.native.loader`` load its native library in this
    process, whatever ran earlier in it; return whether it did (False
    only without a C++ compiler).

    Builds ``fast_batcher.cpp`` to the path and with the flags of JAX's
    loader, under an ``fcntl.flock`` on a lock file in JAX's cache
    directory, through a per-process temporary name and ``os.replace``
    (the rule of the port's loader); a library newer than the source
    that loads is kept. Where JAX's loader already recorded a failed
    try, ``monkeypatch`` resets its memo (``_TRIED``) so that it loads
    the library that now exists; what it computes is untouched."""
    if shutil.which("c++") is None:
        return False
    cache_dir = os.path.join(tempfile.gettempdir(),
                             "mxfusion_tpu_native_{}".format(os.getuid()))
    os.makedirs(cache_dir, exist_ok=True)
    lib_path = os.path.join(cache_dir, "libfastbatcher.so")
    with open(os.path.join(cache_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _loads(lib_path) or \
                os.path.getmtime(lib_path) < os.path.getmtime(jloader._SRC):
            tmp = "{}.{}".format(lib_path, os.getpid())
            subprocess.run(
                ["c++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp, jloader._SRC, "-lpthread"],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib_path)
    if jloader._TRIED and jloader._LIB is None:
        monkeypatch.setattr(jloader, "_TRIED", False)
    return jloader.native_available()


def _loads(lib_path):
    """Whether ``lib_path`` exists and is a whole library (a build that
    raced through JAX's shared temporary name may not be)."""
    import ctypes
    try:
        ctypes.CDLL(lib_path).shuffled_indices
    except (OSError, AttributeError):
        return False
    return True


@pytest.fixture
def both_native(monkeypatch):
    """Both packages' batchers native, checked at test time: skips only
    without a C++ compiler, fails where one exists and a loader falls
    back."""
    if shutil.which("c++") is None:
        pytest.skip("no C++ compiler: neither package's batcher builds")
    assert native_available(), "the port's native batcher did not load"
    assert jax_native_ready(monkeypatch), \
        "JAX's native batcher did not load"


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


@pytest.fixture
def fallback(monkeypatch):
    """Force the numpy fallback regardless of the compiler."""
    monkeypatch.setattr(loader, "_LIB", None)
    monkeypatch.setattr(loader, "_TRIED", True)


@pytest.mark.parametrize("shape", [(1000, 17), (100, 4, 3), (50,)])
def test_gather_rows_matches_numpy(shape):
    rng = np.random.default_rng(len(shape))
    src = rng.standard_normal(shape).astype(np.float32)
    idx = rng.integers(0, shape[0], size=256)
    assert np.array_equal(gather_rows(src, idx), src[idx])
    out = np.empty((256,) + shape[1:], np.float32)
    assert gather_rows(src, idx, out=out) is out
    assert np.array_equal(out, src[idx])


def test_shuffled_indices_is_permutation_and_deterministic():
    a = shuffled_indices(1000, seed=7)
    assert np.array_equal(np.sort(a), np.arange(1000))
    assert np.array_equal(a, shuffled_indices(1000, seed=7))
    assert not np.array_equal(a, shuffled_indices(1000, seed=8))


@pytest.mark.usefixtures("both_native")
@pytest.mark.parametrize("n,seed", [(1, 0), (230, 0), (230, 1), (4097, 2),
                                    (100_000, 12345)])
def test_shuffled_indices_equal_jax_native(n, seed):
    from mxfusion_tpu.native import shuffled_indices as jshuffled
    assert np.array_equal(shuffled_indices(n, seed), jshuffled(n, seed))


def test_fallback_path(fallback):
    rng = np.random.default_rng(2)
    src = rng.standard_normal((50, 3))
    idx = rng.integers(0, 50, size=20)
    assert not native_available()
    assert np.array_equal(gather_rows(src, idx), src[idx])
    assert np.array_equal(shuffled_indices(50, seed=1),
                          np.random.default_rng(1).permutation(50))


@pytest.mark.parametrize("path", ["native", "fallback"])
def test_gather_rows_bounds_checked(request, path):
    if path == "fallback":
        request.getfixturevalue("fallback")
    src = np.zeros((10, 3))
    for bad in ([-1, 0], [0, 10], [99]):
        with pytest.raises(IndexError):
            gather_rows(src, np.asarray(bad, dtype=np.int64))


def test_library_is_built_under_the_repository():
    """Built into build/native/ beside the package (git ignores it), not
    into a temporary directory; rebuilt when the source is newer."""
    if shutil.which("c++") is None:
        pytest.skip("no C++ compiler")
    assert native_available()
    lib = loader.BUILD_DIR / "libfastbatcher.so"
    assert lib.is_file()
    root = loader.BUILD_DIR.parents[1]
    assert (root / "mxfusion_tpu_torch").is_dir()
    assert lib.stat().st_mtime >= os.path.getmtime(loader._SRC)


@pytest.mark.usefixtures("both_native")
@pytest.mark.parametrize("N", [230, 4097])
@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_epoch_batches_equal_jax(N, epoch):
    """Fault C1: the port's host loop used numpy's permutation where JAX
    used the native one; both now take ``native.shuffled_indices``."""
    B = 64
    ours = MinibatchInferenceLoop(batch_size=B)._epoch_batches(N, epoch)
    theirs = JMinibatch(batch_size=B)._epoch_batches(N, epoch)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)


@pytest.mark.usefixtures("both_native")
def test_minibatch_trajectory_matches_jax_natively():
    """MAP + MinibatchInferenceLoop + Adam for 3 epochs of 4 batches
    (the last one rolled over), with neither package patched: per-epoch
    losses rtol 1e-6, final parameters rtol 1e-5 (atol 1e-8), as the
    forced-fallback test holds them."""
    N, B = 230, 64
    X, Y, Z0 = _data(7, N, 2, 12)
    with jax_f64():
        jm_loop = JMinibatch(batch_size=B)
    jinf, tinf = _pair(X, Y, Z0, jloop=jm_loop,
                       loop=MinibatchInferenceLoop(batch_size=B), key=3)
    jm_loop.rv_scaling = {jinf.graphs[0].Y.uuid: N / B}
    tinf.grad_loop.rv_scaling = {tinf.graphs[0].Y.uuid: N / B}
    jl, tl = [], []
    with jax_f64():
        jinf.run(max_iter=3, learning_rate=0.05, X=X, Y=Y,
                 key=jax.random.PRNGKey(3),
                 callback=lambda e, l: jl.append(float(l)))
    tinf.run(max_iter=3, learning_rate=0.05, X=X, Y=Y,
             callback=lambda e, l: tl.append(float(l)))
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    jp, tp = _by_path(jinf), _by_path(tinf)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-8,
                                   err_msg=k)
