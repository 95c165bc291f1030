"""The port's CUDA kernel wrappers and their build, without JAX.

The tests marked ``cuda`` hold each CUDA kernel against its plain
PyTorch version on the card; they skip on a machine without one. This
file imports no JAX, so it runs on a card machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""
import stat

import numpy as np
import pytest
import torch

from mxfusion_tpu_torch.ops import cuda_build, cuda_kernels as ck
from mxfusion_tpu_torch.ops import precision

# (s, N, M, D, ARD): X2 = None for M None; ragged N, M and D throughout
CASES = [(1, 37, 53, 3, True), (1, 64, None, 5, False),
         (2, 19, 7, 4, True), (3, 11, None, 2, True), (1, 1, 1, 1, False)]


def _inputs(seed, s, N, M, D, ard, dtype=np.float64):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((s, N, D)).astype(dtype)
    X2 = None if M is None else rng.standard_normal((s, M, D)).astype(dtype)
    ls = (rng.random((s, D if ard else 1)) + 0.5).astype(dtype)
    var = (rng.random((s, 1)) + 0.5).astype(dtype)
    return X, X2, ls, var


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def test_wrapper_takes_plain_version_on_cpu():
    X, X2, ls, var = _inputs(3, 1, 9, 5, 3, True, dtype=np.float32)
    before = ck.rbf_kernel_matrix.launches
    K = ck.rbf_kernel_matrix(_t(X), _t(X2), _t(ls), _t(var))
    assert ck.rbf_kernel_matrix.launches == before
    assert torch.equal(K, ck._rbf_torch(_t(X), _t(X2), _t(ls), _t(var)))


def test_wrapper_rejects_other_devices():
    X = torch.zeros((1, 4, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ck.rbf_kernel_matrix(X, None, torch.ones((1, 1), device="meta"),
                             torch.ones((1, 1), device="meta"))


def test_kernel_gate_flag_and_dtype():
    x32 = torch.zeros((1, 4, 2), dtype=torch.float32)
    x64 = torch.zeros((1, 4, 2), dtype=torch.float64)
    assert ck.use_kernel()  # on by default
    assert ck.kernel_eligible(x32, None) and ck.kernel_eligible(x32, x32)
    assert not ck.kernel_eligible(x64, None)
    ck.set_use_kernel(False)
    try:
        assert not ck.kernel_eligible(x32, None)
    finally:
        ck.set_use_kernel(True)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("rbf_gram.cu")


def test_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        cuda_build.build("rbf_gram.cu")
    assert not any(p.suffix == ".so" or p.name.endswith(".tmp")
                   for p in (tmp_path / "build").iterdir())


def test_library_path_is_keyed_by_source(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    first = cuda_build.library_path("k.cu")
    src.write_text("// two\n")
    assert cuda_build.library_path("k.cu") != first
    assert first.parent == cuda_build.BUILD_DIR and \
        first.name.startswith("k-") and first.suffix == ".so"


# ---------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("s,N,M,D,ard", CASES + [(1, 512, 8192, 32, False),
                                                 (1, 300, 1000, 7, True),
                                                 (1, 65, 130, 70, True)])
def test_cuda_kernel_matches_plain(cuda_device, s, N, M, D, ard):
    X, X2, ls, var = _inputs(4, s, N, M, D, ard, dtype=np.float32)
    var = np.ones_like(var)

    def dev(a):
        return None if a is None else torch.as_tensor(a, device=cuda_device)

    before = ck.rbf_kernel_matrix.launches
    with torch.no_grad():
        K = ck.rbf_kernel_matrix(dev(X), dev(X2), dev(ls), dev(var))
        P = ck._rbf_torch(dev(X), dev(X2), dev(ls), dev(var))
    torch.cuda.synchronize()
    assert ck.rbf_kernel_matrix.launches == before + 1
    assert K.shape == P.shape
    assert float((K - P).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take(cuda_device):
    X = torch.zeros((1, 8, 3), device=cuda_device)
    one = torch.ones((1, 1), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ck.rbf_kernel_matrix(X.transpose(1, 2).contiguous().transpose(1, 2),
                             None, one, one)
    with pytest.raises(ValueError, match="float32"):
        ck.rbf_kernel_matrix(X.double(), None, one.double(), one.double())
    with pytest.raises(NotImplementedError, match="no backward"):
        ck.rbf_kernel_matrix(X.requires_grad_(), None, one, one)


@pytest.mark.cuda
def test_cuda_highest_einsum_ignores_tf32(cuda_device):
    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.uniform(0, 4, (512, 32)), dtype=torch.float32,
                        device=cuda_device)
    B = torch.as_tensor(rng.uniform(0, 4, (4096, 32)), dtype=torch.float32,
                        device=cuda_device)
    old = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        C = precision.einsum("nd,md->nm", A, B)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(old)
    ref = A.double() @ B.double().T
    assert float((C.double() - ref).abs().max() / ref.abs().max()) <= 1e-5


def test_asking_for_cuda_never_yields_the_cpu():
    from mxfusion_tpu_torch.common import config
    if torch.cuda.is_available():
        assert config.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            config.resolve_device("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            config.set_default_device("cuda")
    assert config.resolve_device("cpu").type == "cpu"
    assert config.get_default_device().type == \
        ("cuda" if torch.cuda.is_available() else "cpu")


def test_highest_einsum_restores_matmul_precision():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with precision.ieee_fp32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(old)
