"""The port's RBF gram (mxfusion_tpu_torch.ops.cuda_kernels) against the
JAX package's (mxfusion_tpu.ops.pallas_kernels).

On the CPU the wrapper takes the plain version. The CUDA kernel itself
is held against that plain version on the card, by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_cuda_kernels import CASES, _inputs, _t
from mxfusion_tpu.ops import pallas_kernels as pk
from mxfusion_tpu.components.distributions.gp.kernels import RBF as JRBF
from mxfusion_tpu_torch.ops import cuda_kernels as ck
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.fixture
def force_interpret():
    pk.set_use_pallas(True)
    pk.set_force_interpret(True)
    yield
    pk.set_force_interpret(False)
    pk.set_use_pallas(False)


@pytest.mark.parametrize("s,N,M,D,ard", CASES)
def test_plain_rbf_matches_jnp_f64(s, N, M, D, ard):
    X, X2, ls, var = _inputs(0, s, N, M, D, ard)
    K = ck._rbf_torch(_t(X), _t(X2), _t(ls), _t(var))
    Kj = pk._rbf_jnp(_j(X), _j(X2), _j(ls), _j(var))
    assert K.shape == (s, N, N if M is None else M)
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("N,M,D,ard", [(256, 128, 5, True),
                                       (128, None, 3, False)])
def test_wrapper_matches_pallas_interpret_f32(force_interpret, N, M, D,
                                              ard):
    # the Pallas kernel takes 128-aligned shapes only
    X, X2, ls, var = _inputs(1, 1, N, M, D, ard, dtype=np.float32)
    K = ck.rbf_kernel_matrix(_t(X), _t(X2), _t(ls), _t(var))
    Kj = pk.rbf_kernel_matrix(_j(X), _j(X2), _j(ls), _j(var))
    assert K.dtype == torch.float32 and Kj.dtype == jnp.float32
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("active_dims", [None, [0, 2]])
def test_rbf_kernel_class_matches_jax(dtype, active_dims):
    """RBF.K / Kdiag through the kernel classes (prefixed parameters,
    active_dims slicing, the gate into the wrapper for float32)."""
    rng = np.random.default_rng(2)
    D = 4
    n_act = D if active_dims is None else len(active_dims)
    X = rng.standard_normal((1, 13, D)).astype(dtype)
    X2 = rng.standard_normal((1, 6, D)).astype(dtype)
    params = {"rbf_lengthscale": (rng.random((1, n_act)) + 0.5)
              .astype(dtype),
              "rbf_variance": (rng.random((1, 1)) + 0.5).astype(dtype)}
    kern = RBF(input_dim=n_act, ARD=True, active_dims=active_dims)
    jkern = JRBF(input_dim=n_act, ARD=True, active_dims=active_dims)
    tol = 1e-12 if dtype == "float64" else 1e-5
    for X2_ in (X2, None):
        K = kern.K(_t(X), _t(X2_), **{k: _t(v) for k, v in params.items()})
        Kj = jkern.K(_j(X), _j(X2_), **{k: _j(v) for k, v in
                                        params.items()})
        np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=tol,
                                   atol=tol)
    Kd = kern.Kdiag(_t(X), **{k: _t(v) for k, v in params.items()})
    np.testing.assert_allclose(Kd.numpy(), np.full((1, 13),
                                                   params["rbf_variance"][0,
                                                                          0]))
