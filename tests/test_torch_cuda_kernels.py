"""The port's CUDA kernel wrappers and their build, without JAX.

K1 (``rbf_gram.cu``) with its gradient, K2 and K3 (``fused_gram.cu``),
K4 and K5 (``batched_cholesky.cu``) and the precision tiers on the card.

The tests marked ``cuda`` hold each CUDA kernel against its plain
PyTorch version on the card; they skip on a machine without one. This
file imports no JAX, so it runs on a card machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""
import importlib
import stat

import numpy as np
import pytest
import torch

from mxfusion_tpu_torch.ops import cuda_build, cuda_kernels as ck
from mxfusion_tpu_torch.ops import fused_gram as fg
from mxfusion_tpu_torch.ops import linalg
from mxfusion_tpu_torch.ops import precision

# the module (ops.batched_cholesky is the function, as in JAX)
bc = importlib.import_module("mxfusion_tpu_torch.ops.batched_cholesky")

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


# ---------------------------------------------------------------------
# K1's route on inputs broadcast over the sample axis (s = 3): the port's
# side of the two cases, on any device (the JAX side is in
# tests/test_torch_rbf_route.py)
# ---------------------------------------------------------------------

def _gp_inputs(seed=21, s=3, N=40, D=3):
    """GaussianProcess inputs: X (1, N, D) shared by the s samples of f,
    f (s, N, 2), an ARD lengthscale (1, D) and a variance (1, 1)."""
    rng = np.random.default_rng(seed)
    return (rng.random((1, N, D)) * 4, rng.standard_normal((s, N, 2)),
            rng.random((1, D)) + 0.7, np.full((1, 1), 0.8))


def _gp_log_pdf(X, F, ls, var, dtype, device, jitter=1e-2):
    """``GaussianProcess.log_pdf`` (RBF, ARD) of s samples of f at one X:
    its ``log_pdf`` broadcasts X and the parameters to the s samples as
    stride-0 views before ``kern.K``."""
    from mxfusion_tpu_torch.components.distributions import GaussianProcess
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.inference import VariableEnv
    kern = RBF(input_dim=X.shape[-1], ARD=True)
    gp = GaussianProcess(X=0.0, kernel=kern, jitter=jitter)
    gp._generate_outputs(shape=F.shape[1:])

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return gp.log_pdf(VariableEnv({
        gp.X.uuid: t(X), gp.random_variable.uuid: t(F),
        kern.lengthscale.uuid: t(ls), kern.variance.uuid: t(var)}))


def _svgp_data(seed=22, N=40, D=3, M=8):
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 4
    Y = np.sin(2 * X[:, :1]) + rng.standard_normal((N, 1)) * 0.1
    return X, Y, rng.random((M, D)) * 4


def _svgp_state(Z0, seed=23):
    """An SVGP MAP store by name path (unconstrained values)."""
    rng = np.random.default_rng(seed)
    M = Z0.shape[0]
    return {"inducing_inputs": Z0, "noise_var": np.full(1, -2.0),
            "Y.rbf_lengthscale": np.full(1, 0.5),
            "Y.rbf_variance": np.full(1, 0.3),
            "Y.qU_mean": rng.standard_normal((M, 1)),
            "Y.qU_cov_W": 0.1 * rng.standard_normal((M, M)),
            "Y.qU_cov_diag": np.full(M, -3.0)}


def _svgp_inference(X, Y, Z0, dtype, device, state=None):
    """The port's SVGP regression under MAP, initialized on ``device``
    and loaded with the name-path ``state`` if one is given."""
    import mxfusion_tpu_torch as mt
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.inference import MAP, GradBasedInference
    from mxfusion_tpu_torch.modules import SVGPRegression
    D = Z0.shape[1]
    m = mt.Model()
    m.n = mt.Variable()
    m.X = mt.Variable(shape=(m.n, D))
    m.noise_var = mt.Variable(transformation=PositiveTransformation(),
                              initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D, variance=1.0, lengthscale=0.8,
                          dtype=dtype),
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=mt.Variable(shape=Z0.shape, initial_value=Z0),
        dtype=dtype)
    inf = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                             dtype=dtype, device=device)
    inf.initialize(X=X, Y=Y)
    if state is not None:
        from mxfusion_tpu_torch.util.carryover import load_state
        load_state(inf.params, state, inf.graphs)
    return inf


def _svgp_bound_sampled_noise(inf, X, Y, noise):
    """The SVGP bound of ``inf``'s store with the noise variance replaced
    by s sampled values ``noise`` (s, 1): ``SVGPRegressionLogPdf.compute``
    broadcasts X, Z and the kernel parameters to s samples (stride-0
    views) before ``kern.K``."""
    from mxfusion_tpu_torch.inference import create_executor
    from mxfusion_tpu_torch.inference.inference_alg import RuntimeContext
    p = inf.params
    ex = create_executor(inf.inference_algorithm, p)
    env = ex.build_env(p.trainable_params(), p.fixed_params(), [X, Y])
    env[inf.graphs[0].noise_var.uuid] = p.as_tensor(noise)
    return inf.inference_algorithm.compute(
        env, RuntimeContext(torch.Generator(p.device)))[0]


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

# 16-byte loads and stores where D % 4 == 0 and M % 4 == 0; elsewhere
# 4-byte ones: M = 8191, 130 and 1 with S = 2 and an odd N put the second
# sample's K off a 16-byte boundary. Kzx (512 x 8192) and the materialized
# training arm's Kuf (512 x 65536), where a block walks many column tiles
WIDE = [(1, 512, 8192, 32, False), (1, 512, 65536, 32, False),
        (1, 300, 1000, 7, True),
        (1, 65, 130, 70, True), (2, 33, 8191, 32, False),
        (2, 65, 130, 8, True), (2, 37, 1, 4, True), (2, 64, 256, 32, True),
        (2, 30, 128, 7, True), (2, 70, None, 12, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,N,M,D,ard", CASES + WIDE)
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
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ck.rbf_kernel_matrix(X.to("meta"), None, one, one)


@pytest.mark.cuda
def test_cuda_sample_broadcast_launches_the_kernel(cuda_device):
    """K1's route on inputs broadcast over s = 3 samples (stride-0
    views): ``GaussianProcess.log_pdf`` of three samples of f and an SVGP
    bound with three sampled noise variances run on the card, launch K1
    (the gram of the log-pdf; Kuu and Kuf of the bound), and match their
    CPU values (float32; the kernel and the plain gram differ by fp32
    summation order, which the Cholesky of a gram at jitter 1e-2
    amplifies): 1e-4 relative per sample."""
    before = ck.rbf_kernel_matrix.launches
    args = _gp_inputs()
    got = _gp_log_pdf(*args, torch.float32, cuda_device)
    torch.cuda.synchronize()
    assert ck.rbf_kernel_matrix.launches == before + 1
    want = _gp_log_pdf(*args, torch.float32, "cpu")
    assert got.shape == want.shape == (3,)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=0)

    X, Y, Z0 = _svgp_data()
    noise = np.array([[0.05], [0.1], [0.3]])
    bounds = []
    for device in (cuda_device, "cpu"):
        inf = _svgp_inference(X, Y, Z0, "float32", device, _svgp_state(Z0))
        before = ck.rbf_kernel_matrix.launches
        with torch.no_grad():
            bounds.append(_svgp_bound_sampled_noise(inf, X, Y, noise).cpu())
        if device != "cpu":
            torch.cuda.synchronize()
            assert ck.rbf_kernel_matrix.launches == before + 2
    assert bool(torch.isfinite(bounds[0]).all())
    torch.testing.assert_close(bounds[0], bounds[1], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_cuda_classification_bound_builds_its_grams_with_k1(cuda_device):
    """The SVGP classification bound at M = 512, N = 8192, D = 32 (the
    wide unwhitened arm, float32): each evaluation launches K1 twice (Kuu,
    Kuf), and its loss is the plain gram's within 1e-5 relative."""
    import mxfusion_tpu_torch as mt
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.inference import (MAP, GradBasedInference,
                                              create_executor)
    from mxfusion_tpu_torch.modules import SVGPClassification
    from mxfusion_tpu_torch.util.carryover import load_state
    N, M, D = 8192, 512, 32
    rng = np.random.default_rng(24)
    X = rng.random((N, D)) * 4
    Y = (rng.random((N, 1)) < 0.5).astype(np.float64)
    m = mt.Model()
    m.n = mt.Variable()
    m.X = mt.Variable(shape=(m.n, D))
    m.Y = SVGPClassification.define_variable(
        X=m.X, kernel=RBF(input_dim=D, lengthscale=float(np.sqrt(D))),
        shape=(m.n, 1), inducing_inputs=mt.Variable(shape=(M, D)))
    inf = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                             device=cuda_device)
    inf.initialize(X=X, Y=Y)
    load_state(inf.params, {
        "inducing_inputs": rng.random((M, D)) * 4,
        "Y.qU_mean": rng.standard_normal((M, 1)),
        "Y.qU_cov_W": 0.05 * rng.standard_normal((M, M)),
        "Y.qU_cov_diag": np.full(M, -4.0)}, inf.graphs)
    ex = create_executor(inf.inference_algorithm, inf.params)
    losses = []
    for use in (True, False):
        ck.set_use_kernel(use)
        try:
            before = ck.rbf_kernel_matrix.launches
            with torch.no_grad():
                losses.append(float(ex(inf.params.trainable_params(),
                                       inf.params.fixed_params(), [X, Y],
                                       None)[0]))
            torch.cuda.synchronize()
            assert ck.rbf_kernel_matrix.launches == before + \
                (2 if use else 0)
        finally:
            ck.set_use_kernel(True)
    assert np.isfinite(losses[0])
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1]), losses


@pytest.mark.cuda
def test_cuda_deep_gp_bound_launches_k1_on_every_layer(cuda_device,
                                                       monkeypatch):
    """A 2-layer deep GP bound (RBF(8) → 6 hidden → RBF(6) → 1, M = 64,
    N = 2048, S = 5 propagation draws, float32) launches K1 four times:
    Kuu and Kuf of each layer, layer 1's Kuf at s = 5 from a Z at s = 1
    through the route's expansion. On the same fixed draws its loss is
    the plain grams' within 1e-4 relative."""
    import mxfusion_tpu_torch as mt
    from mxfusion_tpu_torch.components.distributions import \
        FixedRandomGenerator
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.inference import (MAP, GradBasedInference,
                                              create_executor)
    from mxfusion_tpu_torch.modules import DeepGPRegression
    N, M, D, H, S = 2048, 64, 8, 6, 5
    rng = np.random.default_rng(27)
    X = rng.random((N, D)) * 4
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    m = mt.Model()
    m.n = mt.Variable()
    m.X = mt.Variable(shape=(m.n, D))
    m.noise_var = mt.Variable(transformation=PositiveTransformation(),
                              initial_value=0.1)
    m.Y = DeepGPRegression.define_variable(
        X=m.X, kernels=[RBF(input_dim=D, lengthscale=float(np.sqrt(D))),
                        RBF(input_dim=H, lengthscale=float(np.sqrt(H)))],
        noise_var=m.noise_var, shape=(m.n, 1), num_samples=S,
        inducing_inputs=[mt.Variable(shape=(M, D),
                                     initial_value=rng.random((M, D)) * 4),
                         mt.Variable(shape=(M, H),
                                     initial_value=rng.standard_normal(
                                         (M, H)))],
        rand_gen=FixedRandomGenerator(rng.standard_normal(S * N * H)))
    inf = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                             device=cuda_device)
    inf.initialize(X=X, Y=Y)
    ex = create_executor(inf.inference_algorithm, inf.params)
    shapes = []
    real = ck._rbf_cuda

    def record(X, X2, lengthscale, variance):
        shapes.append((X.shape[0], (X if X2 is None else X2).shape[0]))
        return real(X, X2, lengthscale, variance)
    monkeypatch.setattr(ck, "_rbf_cuda", record)
    losses = []
    for use in (True, False):
        m.Y.factor._rand_gen.reset()
        ck.set_use_kernel(use)
        try:
            before = ck.rbf_kernel_matrix.launches
            with torch.no_grad():
                losses.append(float(ex(
                    inf.params.trainable_params(), inf.params.fixed_params(),
                    [X, Y], torch.Generator(cuda_device))[0]))
            torch.cuda.synchronize()
            assert ck.rbf_kernel_matrix.launches == before + (4 if use else 0)
        finally:
            ck.set_use_kernel(True)
    assert shapes == [(1, 1), (1, 1), (1, 1), (S, S)]
    assert np.isfinite(losses[0])
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1]), losses


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


@pytest.fixture
def no_default_device():
    """No default device set, whatever the other tests set; restored
    afterwards."""
    from mxfusion_tpu_torch.common import config
    old = config.set_default_device(None)
    yield config
    config.set_default_device(old)


def test_asking_for_cuda_never_yields_the_cpu(no_default_device):
    """The default is the card: with none, the default device raises
    (naming ``set_default_device("cpu")``) instead of carrying on on the
    CPU; asking for the CPU works."""
    config = no_default_device
    if torch.cuda.is_available():
        assert config.resolve_device("cuda").type == "cuda"
        assert config.get_default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            config.resolve_device("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            config.set_default_device("cuda")
        with pytest.raises(RuntimeError,
                           match=r'set_default_device\("cpu"\)'):
            config.get_default_device()
        with pytest.raises(RuntimeError, match="no device was given"):
            config.resolve_device(None)
    assert config.resolve_device("cpu").type == "cpu"


def test_asking_for_the_cpu_sets_the_default(no_default_device):
    """``set_default_device("cpu")`` makes the CPU the default; None
    restores the card as the default."""
    config = no_default_device
    config.set_default_device("cpu")
    assert config.get_default_device() == torch.device("cpu")
    assert config.resolve_device(None) == torch.device("cpu")
    config.set_default_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no device was given"):
            config.get_default_device()


def test_highest_einsum_restores_matmul_precision():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with precision._matmul_precision("highest"):
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(old)


@pytest.mark.cuda
@pytest.mark.parametrize("X2_none", [False, True])
def test_cuda_kernel_gradient_matches_plain(cuda_device, X2_none):
    """K1's backward recomputes through the plain version; the gradient
    of the kernel path and of the plain path agree (the forward values
    differ by fp32 summation order only)."""
    X, X2, ls, var = _inputs(6, 1, 300, None if X2_none else 200, 7, True,
                             dtype=np.float32)

    def grads(fn):
        ts = [None if a is None else
              torch.as_tensor(a, device=cuda_device).requires_grad_(True)
              for a in (X, X2, ls, var)]
        K = fn(*ts)
        torch.sum(torch.sin(K)).backward()
        return [t.grad for t in ts if t is not None]

    before = ck.rbf_kernel_matrix.launches
    got = grads(ck.rbf_kernel_matrix)
    assert ck.rbf_kernel_matrix.launches == before + 1
    want = grads(ck._rbf_torch)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


# (128, 4104, 8) and (512, 100000, 32): N % 4 = 0 with dU slices of a
# length that is not a multiple of 4 before du_slices aligned them
FUSED = [(128, 2048, 8), (200, 5037, 7), (1, 1, 1), (130, 300, 128),
         (512, 65536, 32), (128, 4104, 8), (512, 100000, 32)]


def _fused_inputs(seed, M, N, D, device, upper=0.0):
    """A lower-triangular L⁻¹ stand-in plus ``upper`` times noise above
    the diagonal (which ``lower=True`` must ignore)."""
    rng = np.random.default_rng(seed)
    ls = np.sqrt(D)
    Zs = rng.uniform(0, 4, (M, D)) / ls
    Xs = rng.uniform(0, 4, (N, D)) / ls
    A = rng.standard_normal((M, M))
    Linv = np.tril(A * 0.05) + np.eye(M) + upper * np.triu(A, 1)
    dG = rng.standard_normal((M, N)) * 0.01
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (Linv, Zs, Xs, np.asarray(1.4), dG)]


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("M,N,D", FUSED)
def test_cuda_fused_forward_matches_plain(cuda_device, M, N, D, lower):
    Linv, Zs, Xs, var, _ = _fused_inputs(7, M, N, D, cuda_device, 0.05)
    before = fg._fwd_cuda.launches
    G = fg._fwd_cuda(Linv, Zs, Xs, var, lower)
    P = fg._fused_fwd_torch(Linv, Zs, Xs, var, lower)
    torch.cuda.synchronize()
    assert fg._fwd_cuda.launches == before + 1
    assert G.shape == (M, N)
    torch.testing.assert_close(G, P, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("M,N,D", FUSED)
def test_cuda_fused_backward_matches_plain_and_is_deterministic(
        cuda_device, M, N, D, lower):
    """rtol 2e-3 of each tensor's largest entry; two calls give the same
    bits (fixed-order partial sums, no atomics); under ``lower`` the
    upper triangle of dU is exactly 0."""
    Linv, Zs, Xs, var, dG = _fused_inputs(8, M, N, D, cuda_device, 0.05)
    G = fg._fwd_cuda(Linv, Zs, Xs, var, lower)
    before = fg._bwd_cuda.launches
    first = fg._bwd_cuda(Linv, Zs, Xs, var, dG, G, lower)
    second = fg._bwd_cuda(Linv, Zs, Xs, var, dG, G, lower)
    plain = fg._fused_bwd_torch(Linv, Zs, Xs, var, dG, lower)
    torch.cuda.synchronize()
    assert fg._bwd_cuda.launches == before + 2 * fg.BWD_LAUNCHES
    for a, b, p in zip(first, second, plain):
        assert torch.equal(a, b)
        assert a.shape == p.shape
        assert float((a - p).abs().max()) <= \
            2e-3 * max(float(p.abs().max()), 1e-30)
    if lower:
        assert bool((torch.triu(first[0], 1) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [False, True])
def test_cuda_fused_function_runs_both_kernels(cuda_device, lower):
    Linv, Zs, Xs, var, dG = _fused_inputs(9, 64, 1000, 4, cuda_device, 0.05)
    args = [t.requires_grad_(True) for t in (Linv, Zs, Xs, var)]
    f0, b0 = fg._fwd_cuda.launches, fg._bwd_cuda.launches
    fg.fused_linv_rbf_gram(*args, lower=lower).backward(dG)
    assert fg._fwd_cuda.launches == f0 + 1
    assert fg._bwd_cuda.launches == b0 + fg.BWD_LAUNCHES
    assert args[3].grad.shape == var.shape
    assert bool((torch.triu(args[0].grad, 1) == 0).all()) == lower


@pytest.mark.cuda
def test_cuda_fused_rejects_what_it_does_not_take(cuda_device):
    Linv, Zs, Xs, var, _ = _fused_inputs(10, 8, 16, 3, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        fg._fwd_cuda(Linv.double(), Zs.double(), Xs.double(), var.double())
    with pytest.raises(ValueError, match="contiguous"):
        fg._fwd_cuda(Linv.T.contiguous().T, Zs, Xs, var)
    wide = torch.zeros((8, 129), device=cuda_device)
    with pytest.raises(ValueError, match="D = 129"):
        fg._fwd_cuda(Linv, wide, torch.zeros((16, 129), device=cuda_device),
                     var)


@pytest.mark.cuda
def test_cuda_tiers_set_their_precision_in_both_directions(cuda_device):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in (torch.ops.aten.mm,
                                       torch.ops.aten.bmm):
                self.seen.append(torch.get_float32_matmul_precision())
            return func(*args, **(kwargs or {}))

    A = torch.ones((1, 64, 32), device=cuda_device, requires_grad=True)
    B = torch.ones((1, 32, 16), device=cuda_device, requires_grad=True)
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        for fn, fwd, bwd in (
                (lambda: precision.einsum("...ij,...jk->...ik", A, B),
                 "highest", "highest"),
                (lambda: precision.guarded_forward_matmul(A, B),
                 "highest", "high"),
                (lambda: precision.data_einsum("...ij,...jk->...ik", A, B),
                 "high", "high")):
            rec = Record()
            rec.seen = []
            with rec:
                out = fn()
                n_fwd = len(rec.seen)
                out.sum().backward()
            assert set(rec.seen[:n_fwd]) == {fwd}, rec.seen
            assert set(rec.seen[n_fwd:]) == {bwd}, rec.seen
    finally:
        torch.set_float32_matmul_precision(old)


# (B, n): the MVN slice's stacks, the JAX benchmark's shapes, a ragged B
# and n that are not multiples of 8
CHOL = [(512, 32), (512, 64), (2048, 64), (512, 128), (8192, 64), (37, 24),
        (100, 20), (3, 1), (5, 127),
        # the tier edges (a warp per matrix up to 32 and 64, a block above)
        # at B that are not multiples of the matrices per block
        (1, 32), (3, 33), (777, 64), (1, 65), (3, 128), (777, 33), (3, 2),
        (1, 1),
        # the block tier: the Q = 128 PPCA step's stack, n = 96, and n % 4
        # != 0 at a ragged B
        (2048, 128), (512, 96), (33, 100)]


def _spd32(B, n, seed, device):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((B, n, n))
    A = W @ np.swapaxes(W, -1, -2) + n * np.eye(n)
    return torch.as_tensor(A, dtype=torch.float32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", CHOL)
@pytest.mark.parametrize("variant", ["K4", "K5"])
def test_cuda_cholesky_matches_plain(cuda_device, variant, B, n):
    """Within 5e-6 of max |L| of the float64 factor and of the float32
    plain version (the JAX test's bound), upper triangle exactly 0, the
    same bits on a second call, one launch per call."""
    A = _spd32(B, n, 11, cuda_device)
    wrapper = bc._k4_cuda if variant == "K4" else bc._k5_cuda
    before = wrapper.launches
    L1 = wrapper(A)
    L2 = wrapper(A)
    ref = linalg.cholesky(A.double())
    plain = linalg.cholesky(A)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(L1, L2)
    assert bool((torch.triu(L1, 1) == 0).all())
    scale = float(ref.abs().max())
    assert float((L1.double() - ref).abs().max()) <= 5e-6 * scale
    assert float((L1 - plain).abs().max()) <= 5e-6 * scale


@pytest.mark.cuda
def test_cuda_cholesky_gradient_matches_torch(cuda_device):
    """The custom backward around K4 against ``torch.linalg.cholesky``'s
    own gradient on the card, float32: 1e-4 of the largest entry."""
    A = _spd32(512, 64, 12, cuda_device)
    G = torch.as_tensor(np.random.default_rng(13).standard_normal(
        (512, 64, 64)), dtype=torch.float32, device=cuda_device)

    def grad(fn):
        a = A.clone().requires_grad_(True)
        torch.sum(fn(a) * G).backward()
        return a.grad

    before = bc._k4_cuda.launches
    g = grad(bc.batched_cholesky)
    assert bc._k4_cuda.launches == before + 1
    gt = grad(torch.linalg.cholesky)
    g, gt = g + g.transpose(-1, -2), gt + gt.transpose(-1, -2)
    assert float((g - gt).abs().max()) <= 1e-4 * float(gt.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 40, 70])
@pytest.mark.parametrize("variant", ["K4", "K5"])
def test_cuda_cholesky_not_positive_definite(cuda_device, variant, n):
    """The kernels give the plain version's (and JAX's) NaN pattern: the
    whole lower triangle of a failed matrix, 0 above it (at each of K4's
    tiers)."""
    A = _spd32(6, n, 14, cuda_device)
    A[2] = -A[2]
    A[4, 0, 1] = A[4, 1, 0] = 10 * A[4, 0, 0]
    wrapper = bc._k4_cuda if variant == "K4" else bc._k5_cuda
    L = wrapper(A)
    P = linalg.cholesky(A)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(L), torch.isnan(P))
    assert int(torch.isnan(L).sum()) == 2 * n * (n + 1) // 2
    assert bool((torch.triu(L, 1) == 0).all())
    ok = [0, 1, 3, 5]
    assert torch.equal(L[ok], wrapper(A[ok].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 64, 100])
@pytest.mark.parametrize("variant", ["K4", "K5"])
def test_cuda_cholesky_unaligned_stack(cuda_device, variant, n):
    """A stack that starts 4 bytes past a 16-byte boundary takes the
    kernel's 4-byte copies and gives the bits of the aligned stack."""
    A = _spd32(5, n, 16, cuda_device)
    buf = torch.empty(A.numel() + 1, device=cuda_device)
    shifted = buf[1:].view(A.shape)
    shifted.copy_(A)
    assert shifted.data_ptr() % 16 != 0
    wrapper = bc._k4_cuda if variant == "K4" else bc._k5_cuda
    assert torch.equal(wrapper(shifted), wrapper(A))


@pytest.mark.cuda
@pytest.mark.parametrize("n,N", [(1, 32), (20, 32), (20, 64), (33, 64),
                                 (60, 128), (64, 65), (96, 128), (100, 128)])
def test_cuda_identity_padding_gives_the_same_bits(cuda_device, n, N):
    """K4 on an n x n stack and on the same stack padded by the identity
    to N x N, within a tier and across tiers (the warp kernel at 32 and
    64, the tile kernel above): the leading n x n block of the padded
    factor has the bits of the unpadded one (the same fused operations
    on the same values), and the padding's factor is the identity."""
    A = _spd32(7, n, 17, cuda_device)
    P = torch.eye(N, device=cuda_device).repeat(7, 1, 1)
    P[:, :n, :n] = A
    LP = bc._k4_cuda(P)
    torch.cuda.synchronize()
    assert torch.equal(LP[:, :n, :n], bc._k4_cuda(A))
    assert torch.equal(LP[:, n:, n:], torch.eye(N - n, device=cuda_device)
                       .expand(7, -1, -1))
    assert bool((LP[:, n:, :n] == 0).all())


@pytest.mark.cuda
def test_cuda_cholesky_dispatch(cuda_device):
    """``cholesky`` of a broadcast (s, N, n, n) view launches K4 once on
    the dense copy; float64 stays on the plain version; the launchers
    refuse what the kernels do not take."""
    A = _spd32(64, 16, 15, cuda_device)
    before = bc._k4_cuda.launches
    L = bc.cholesky(A[None].expand(4, 64, 16, 16))
    assert bc._k4_cuda.launches == before + 1
    assert L.shape == (4, 64, 16, 16)
    assert torch.equal(L[3], L[0])
    bc.cholesky(A.double())
    assert bc._k4_cuda.launches == before + 1
    for wrapper in (bc._k4_cuda, bc._k5_cuda):
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(A.transpose(1, 2))
        with pytest.raises(ValueError, match="float32"):
            wrapper(A.double())
        with pytest.raises(ValueError, match="n <= 128"):
            wrapper(torch.zeros((2, 129, 129), device=cuda_device))


# ---------------------------------------------------------------------
# K1 on the exact and collapsed GP paths
# ---------------------------------------------------------------------

# (s, N, M, D): D = 1 (the golden; D % 4 != 0, so the 4-byte input path)
# and D = 4 (the exact-GP bench), the symmetric Kxx (M None) at N = 1024
# and 1000, and the prediction chunk's Kxt (1024 x 8192)
GP_SHAPES = [(1, 1024, None, 1), (1, 1024, None, 4), (1, 1000, None, 1),
             (1, 1024, 8192, 4), (1, 1024, 8192, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,N,M,D", GP_SHAPES)
def test_cuda_kernel_matches_plain_at_gp_shapes(cuda_device, s, N, M, D):
    rng = np.random.default_rng(31)

    def dev(a):
        return None if a is None else torch.as_tensor(
            a, dtype=torch.float32, device=cuda_device)
    X = dev(rng.random((s, N, D)) * 4)
    X2 = None if M is None else dev(rng.random((s, M, D)) * 4)
    ls, var = dev(np.ones((s, 1))), dev(np.ones((s, 1)))
    before = ck.rbf_kernel_matrix.launches
    with torch.no_grad():
        K = ck.rbf_kernel_matrix(X, X2, ls, var)
        P = ck._rbf_torch(X, X2, ls, var)
    torch.cuda.synchronize()
    assert ck.rbf_kernel_matrix.launches == before + 1
    assert K.shape == P.shape == (s, N, N if M is None else M)
    assert float((K - P).abs().max()) <= 1e-5


def _combination(combo):
    from mxfusion_tpu_torch.components.distributions.gp import kernels as k
    if combo == "add":
        return k.RBF(2, ARD=True, active_dims=[0, 2]) + k.Matern52(3) + \
            k.White(3)
    return k.RBF(3, active_dims=[2, 0, 1]) * k.Linear(3, ARD=True)


@pytest.mark.cuda
@pytest.mark.parametrize("combo", ["add", "mul"])
def test_cuda_kernel_in_sum_and_product_kernels(cuda_device, combo):
    """An RBF inside an AddKernel (on the ``active_dims`` columns 0 and
    2) or a MultiplyKernel (columns permuted) launches K1 once per gram,
    on the dense copy that ``index_select`` makes; K, K(X) and Kdiag
    match the plain route within 1e-5 of their largest entry (variances
    of order 1; fp32 summation order)."""
    kern = _combination(combo)
    rng = np.random.default_rng(32)
    params = {n: torch.as_tensor(rng.uniform(0.5, 1.5, (1,) + v.shape),
                                 dtype=torch.float32, device=cuda_device)
              for n, v in kern.parameters.items()}
    X = torch.as_tensor(rng.random((1, 300, 3)) * 2, dtype=torch.float32,
                        device=cuda_device)
    X2 = torch.as_tensor(rng.random((1, 200, 3)) * 2, dtype=torch.float32,
                         device=cuda_device)

    def grams():
        with torch.no_grad():
            return (kern.K(X, X2, **params), kern.K(X, **params),
                    kern.Kdiag(X, **params))
    before = ck.rbf_kernel_matrix.launches
    got = grams()
    torch.cuda.synchronize()
    assert ck.rbf_kernel_matrix.launches == before + 2
    ck.set_use_kernel(False)
    try:
        want = grams()
    finally:
        ck.set_use_kernel(True)
    assert ck.rbf_kernel_matrix.launches == before + 2
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
