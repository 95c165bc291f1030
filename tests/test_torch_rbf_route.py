"""K1's route (``RBF._compute_K`` → ``rbf_kernel_matrix``) on inputs
broadcast over the sample axis, against the JAX package.

The port broadcasts the sample axis as a stride-0 view (``as_samples``).
``RBF._compute_K`` copies such a view dense before it hands it to the
kernel's wrapper, and sends inputs the kernel does not take (rank ≠ 3)
to its plain branch, as JAX's ``pallas_eligible`` sends them to
``_rbf_jnp``. Here on the CPU the wrapper runs its plain version, so
these tests hold the arguments the route hands over to the checks
``_rbf_cuda`` runs before its launch, and the two cases that reach the
route with s = 3 (a GP log-pdf of three samples of f, an SVGP bound with
three sampled noise variances) to the JAX package's values.
``tests/test_torch_cuda_kernels.py`` runs the same two cases on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda_kernels import (_gp_inputs, _gp_log_pdf, _svgp_data,
                                     _svgp_bound_sampled_noise,
                                     _svgp_inference)
from test_torch_svgp_training import _by_path, _pair, jax_f64
from mxfusion_tpu.components.distributions import GaussianProcess as JGP
from mxfusion_tpu.components.distributions.gp.kernels import RBF as JRBF
from mxfusion_tpu.inference import (VariableEnv as JEnv,
                                    create_executor as jcreate_executor)
from mxfusion_tpu.inference.inference_alg import RuntimeContext as JCtx
from mxfusion_tpu.ops import pallas_kernels as pk

from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.ops import cuda_kernels as ck

NOISE = np.array([[0.05], [0.1], [0.3]])  # three sampled noise variances


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port runs on the card unless the CPU is asked for: these tests
    ask for it, and put the previous default back afterwards."""
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


@pytest.fixture
def handed_over(monkeypatch):
    """The arguments of every call ``RBF._compute_K`` makes to the
    wrapper, which then runs as before."""
    calls = []
    real = ck.rbf_kernel_matrix

    def record(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(ck, "rbf_kernel_matrix", record)
    return calls


def test_broadcast_arguments_pass_the_kernel_checks(handed_over):
    """X (1, 40, 3) broadcast against s = 3 samples of f: ``log_pdf``
    hands ``kern.K`` a stride-0 (3, 40, 3) view, which the kernel's checks
    refuse; what ``_compute_K`` hands the wrapper is a dense copy with
    (3, D) lengthscales and (3, 1) variances, which they take."""
    X = torch.as_tensor(_gp_inputs()[0], dtype=torch.float32)
    view = X.expand(3, -1, -1)
    one = torch.ones((3, 1), dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ck.check_kernel_args(view, None, one, one)
    _gp_log_pdf(*_gp_inputs(), torch.float32, "cpu")
    assert len(handed_over) == 1
    Xk, X2k, ls, var = handed_over[0]
    assert tuple(Xk.shape) == (3, 40, 3) and X2k is None
    assert tuple(ls.shape) == (3, 3) and tuple(var.shape) == (3, 1)
    ck.check_kernel_args(*handed_over[0])


@pytest.mark.parametrize("shape", [(2, 4, 10, 3), (10, 3)])
def test_other_ranks_take_the_plain_branch(handed_over, shape):
    """X of rank 4 or 2 is not what the kernel takes: the gate is closed,
    the wrapper is not called, and ``RBF.K`` gives ``_rbf_torch``'s gram
    (which JAX's ``_rbf_jnp`` matches, ``test_torch_rbf_kernel.py``)."""
    rng = np.random.default_rng(24)
    X = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    ls = torch.as_tensor(rng.random((1, 3)) + 0.5, dtype=torch.float32)
    var = torch.full((1, 1), 0.7, dtype=torch.float32)
    assert not ck.kernel_eligible(X, None, ls, var)
    K = RBF(input_dim=3, ARD=True).K(X, rbf_lengthscale=ls,
                                     rbf_variance=var)
    assert handed_over == []
    torch.testing.assert_close(K, ck._rbf_torch(X, None, ls, var),
                               rtol=1e-6, atol=1e-6)
    Kj = pk._rbf_jnp(jnp.asarray(X.numpy()), None, jnp.asarray(ls.numpy()),
                     jnp.asarray(var.numpy()))
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("ok,X,X2,ls,var", [
    (True, (3, 40, 3), None, (3, 3), (3, 1)),
    (True, (3, 40, 3), (3, 7, 3), (3, 1), (3, 1)),
    (False, (3, 40, 3), (1, 7, 3), (3, 3), (3, 1)),   # s differs
    (False, (3, 40, 3), (3, 7, 2), (3, 3), (3, 1)),   # D differs
    (False, (3, 40, 3), None, (1, 3), (3, 1)),        # lengthscale not (s, .)
    (False, (3, 40, 3), None, (3, 3), (1, 1)),        # variance not (s,)
    (False, (3, 0, 3), None, (3, 3), (3, 1)),         # empty
    (False, (2, 4, 10, 3), None, (1, 3), (1, 1)),
    (False, (10, 3), None, (1, 3), (1, 1))])
def test_gate_takes_the_shapes_the_kernel_takes(ok, X, X2, ls, var):
    """float32 X and X2 3-D with the same s and D, lengthscale (s, 1) or
    (s, D), variance (s, 1); contiguity is not asked for (the route copies
    a broadcast view dense)."""
    def t(shape):
        return None if shape is None else torch.zeros(shape,
                                                      dtype=torch.float32)
    args = [t(X), t(X2), t(ls), t(var)]
    assert ck.kernel_eligible(*args) == ok
    if ok:
        args[0] = args[0][:1].expand(*X)
        assert ck.kernel_eligible(*args)


def _jax_gp_log_pdf(X, F, ls, var, jitter=1e-2):
    kern = JRBF(input_dim=X.shape[-1], ARD=True)
    gp = JGP(X=0.0, kernel=kern, jitter=jitter)
    gp._generate_outputs(shape=F.shape[1:])
    with jax_f64():
        return np.asarray(gp.log_pdf(JEnv({
            gp.X.uuid: jnp.asarray(X), gp.random_variable.uuid: jnp.asarray(F),
            kern.lengthscale.uuid: jnp.asarray(ls),
            kern.variance.uuid: jnp.asarray(var)})))


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
def test_gp_log_pdf_of_three_samples_matches_jax(handed_over, dtype, rtol):
    """``GaussianProcess.log_pdf`` of s = 3 samples of f at one X (40 × 3,
    ARD, jitter 1e-2) against the JAX package in float64: 1e-10 relative
    in float64 (the plain branch); 1e-4 in float32, where the route hands
    the dense copy to the wrapper (fp32 rounding of the gram, amplified by
    its Cholesky)."""
    args = _gp_inputs()
    got = _gp_log_pdf(*args, dtype, "cpu")
    assert len(handed_over) == (dtype == torch.float32)
    want = _jax_gp_log_pdf(*args)
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=rtol)


def test_svgp_bound_with_sampled_noise_matches_jax(handed_over):
    """The SVGP bound with three sampled noise variances, from the JAX
    store: in float64 within 1e-10 relative of the JAX package's (the
    plain branch); in float32, through the route (Kuu and Kuf handed over
    as dense (3, ·, ·) copies), within 1e-4 relative."""
    X, Y, Z0 = _svgp_data()
    jinf, tinf = _pair(X, Y, Z0)
    with jax_f64():
        jex = jcreate_executor(jinf.inference_algorithm, jinf.params)
        env = jex.build_env(dict(jinf.params.trainable_params()),
                            dict(jinf.params.fixed_params()), [X, Y])
        env[jinf.graphs[0].noise_var.uuid] = jnp.asarray(NOISE)
        want = float(jinf.inference_algorithm.compute(
            env, JCtx(jax.random.PRNGKey(0)))[0])
    with torch.no_grad():
        got64 = float(_svgp_bound_sampled_noise(tinf, X, Y, NOISE))
        assert handed_over == []
        inf32 = _svgp_inference(X, Y, Z0, "float32", "cpu", _by_path(tinf))
        got32 = float(_svgp_bound_sampled_noise(inf32, X, Y, NOISE))
    assert [tuple(a[0].shape) for a in handed_over] == [(3, 8, 3),
                                                        (3, 8, 3)]
    assert all(t.is_contiguous() for a in handed_over for t in a[:2]
               if t is not None)
    assert abs(got64 - want) <= 1e-10 * abs(want)
    assert abs(got32 - want) <= 1e-4 * abs(want)


# ---------------------------------------------------------------------
# mixed sample counts: Z and the parameters at s = 1 against inputs at
# s = S (a deep GP's Kuf beyond its first layer)
# ---------------------------------------------------------------------

def _mixed(seed=31, S=3, M=6, N=9, D=3, ard=True, dtype=torch.float32):
    """Z (1, M, D), A (S, N, D), a (1, D) or (1, 1) lengthscale and a
    (1, 1) variance."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(a, dtype=dtype) for a in (
        rng.random((1, M, D)) * 4, rng.standard_normal((S, N, D)),
        rng.random((1, D if ard else 1)) + 0.6, np.full((1, 1), 0.8)))


@pytest.mark.parametrize("ard", [True, False], ids=["ard", "isotropic"])
@pytest.mark.parametrize("z_first", [True, False], ids=["Kzx", "Kxz"])
def test_mixed_sample_counts_take_the_kernel(handed_over, ard, z_first):
    """Z (1, M, D) against A (3, N, D), a (1, D) or (1, 1) lengthscale
    and a (1, 1) variance: the gate refuses them as they are; the route
    expands the s = 1 operands to s = 3 and hands the wrapper dense
    copies that pass the kernel's checks, one call for the gram."""
    Z, A, ls, var = _mixed(ard=ard)
    X, X2 = (Z, A) if z_first else (A, Z)
    assert not ck.kernel_eligible(X, X2, ls, var)
    K = RBF(input_dim=3, ARD=ard).K(X, X2, rbf_lengthscale=ls,
                                    rbf_variance=var)
    assert len(handed_over) == 1
    Xk, X2k, lsk, vark = handed_over[0]
    assert tuple(Xk.shape[:1]) == tuple(X2k.shape[:1]) == (3,)
    assert tuple(lsk.shape) == ((3, 3) if ard else (3, 1))
    assert tuple(vark.shape) == (3, 1)
    assert all(t.is_contiguous() for t in handed_over[0])
    assert ck.kernel_eligible(*handed_over[0])
    ck.check_kernel_args(*handed_over[0])
    assert tuple(K.shape) == ((3, 6, 9) if z_first else (3, 9, 6))


@pytest.mark.parametrize("z_first", [True, False], ids=["Kzx", "Kxz"])
def test_mixed_sample_counts_plain_gram_matches_jax(handed_over, z_first):
    """In float64 (the plain branch: nothing is handed over) the mixed
    gram is JAX's ``_rbf_jnp`` on the same operands, 1e-12 relative."""
    Z, A, ls, var = _mixed(dtype=torch.float64)
    X, X2 = (Z, A) if z_first else (A, Z)
    K = RBF(input_dim=3, ARD=True).K(X, X2, rbf_lengthscale=ls,
                                     rbf_variance=var)
    assert handed_over == []
    with jax_f64():
        Kj = pk._rbf_jnp(*(jnp.asarray(t.numpy()) for t in (X, X2, ls, var)))
    assert K.shape == Kj.shape
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-12)


def test_mixed_sample_counts_gradients_sum_over_samples(handed_over):
    """Through the route (float32, the expanded copies) the gradients in
    Z, the lengthscale and the variance are the plain branch's: the
    expansion's backward sums them over the s = 3 samples."""
    grads = []
    for use in (True, False):
        Z, A, ls, var = (t.clone().requires_grad_(True) for t in _mixed())
        ck.set_use_kernel(use)
        try:
            K = RBF(input_dim=3, ARD=True).K(Z, A, rbf_lengthscale=ls,
                                             rbf_variance=var)
        finally:
            ck.set_use_kernel(True)
        w = torch.as_tensor(np.random.default_rng(3).standard_normal(
            tuple(K.shape)), dtype=torch.float32)
        torch.sum(K * w).backward()
        grads.append([t.grad for t in (Z, A, ls, var)])
    assert len(handed_over) == 1
    for got, want in zip(*grads):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_one_ard_lengthscale_of_width_s_stays_ard(handed_over):
    """A (1, D) lengthscale with D = s = 3 is one ARD lengthscale, not
    three isotropic ones: expanded along its sample axis, each sample's
    gram uses all three widths, as the plain gram does."""
    Z, A, _, var = _mixed(S=3, D=3)
    ls = torch.tensor([[0.5, 1.0, 3.0]], dtype=torch.float32)
    K = RBF(input_dim=3, ARD=True).K(Z, A, rbf_lengthscale=ls,
                                     rbf_variance=var)
    assert len(handed_over) == 1
    torch.testing.assert_close(handed_over[0][2], ls.expand(3, 3))
    torch.testing.assert_close(K, ck._rbf_torch(Z, A, ls, var), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("X,X2,ls", [
    ((2, 6, 3), (3, 9, 3), (1, 3)),     # neither sample count is 1
    ((1, 6, 3), (3, 9, 3), (2, 3))])    # a lengthscale at another s
def test_other_mixed_counts_take_the_plain_branch(handed_over, X, X2, ls):
    """Sample counts that the expansion cannot reconcile go to the plain
    gram, as JAX's gate sends them to ``_rbf_jnp``."""
    from mxfusion_tpu_torch.components.distributions.gp.kernels.rbf import \
        _one_sample_count
    ops = [torch.ones(shape, dtype=torch.float32)
           for shape in (X, X2, ls, (1, 1))]
    assert not ck.kernel_eligible(*_one_sample_count(*ops))
    with pytest.raises(RuntimeError):
        RBF(input_dim=3, ARD=True).K(*ops[:2], rbf_lengthscale=ops[2],
                                     rbf_variance=ops[3])
    assert handed_over == []
