"""The GP kernel family against the JAX package: K (with and without X2),
Kdiag and their gradients with respect to every parameter and to the
inputs, on the same numpy inputs, float64. Cases mirror
``tests/components/distributions/test_gp_kernels.py``: every kernel
class, ARD on and off, ``active_dims``, sums and products (with the
renaming of duplicate sub-kernels) and ``replicate_self``.

Tolerance: rtol 1e-10 (atol 1e-12 for entries that are 0 in both, such
as White's cross-covariance): both packages run the same float64
formulas, so they differ by rounding alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxfusion_tpu.components.distributions.gp.kernels as jk
import mxfusion_tpu_torch.components.distributions.gp.kernels as tk
from mxfusion_tpu.common import config as jconfig
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.variables import Variable

RTOL, ATOL = 1e-10, 1e-12
D = 3


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port runs on the card unless the CPU is asked for: these tests
    ask for it, and put the previous default back afterwards."""
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


@pytest.fixture(autouse=True)
def _jax_f64():
    old = jconfig.get_default_dtype()
    jconfig.set_default_dtype("float64")
    yield
    jconfig.set_default_dtype(old)


# name -> a function of (kernels module, ARD) returning a kernel over D inputs
CASES = {
    "rbf": lambda k, ard: k.RBF(D, ARD=ard),
    "matern12": lambda k, ard: k.Matern12(D, ARD=ard),
    "matern32": lambda k, ard: k.Matern32(D, ARD=ard),
    "matern52": lambda k, ard: k.Matern52(D, ARD=ard),
    "linear": lambda k, ard: k.Linear(D, ARD=ard),
    "ratquad": lambda k, ard: k.RationalQuadratic(D, ARD=ard),
    "periodic": lambda k, ard: k.Periodic(D, ARD=ard),
    "poly": lambda k, ard: k.Polynomial(D, degree=3, ARD=ard),
    "rbf_active": lambda k, ard: k.RBF(2, ARD=ard, active_dims=[0, 2]),
    "add": lambda k, ard: (k.RBF(2, ARD=ard, active_dims=[0, 1])
                           + k.Matern52(D, ARD=ard) + k.White(D)),
    "mul": lambda k, ard: k.RBF(D, ARD=ard) * k.Linear(D, ARD=ard),
    "mul_active": lambda k, ard: (
        k.Periodic(1, ARD=ard, active_dims=[1])
        * k.RationalQuadratic(2, ARD=ard, active_dims=[0, 2])),
    "add_duplicates": lambda k, ard: k.RBF(D, ARD=ard) + k.RBF(D, ARD=ard),
}
STATIC = {
    "bias": lambda k: k.Bias(D),
    "white": lambda k: k.White(D),
    "bias_plus_white": lambda k: k.Bias(D) + k.White(D),
}


def _param_values(kern, rng):
    """A positive value for every parameter, by prefixed name."""
    return {name: rng.uniform(0.5, 1.5, v.shape)
            for name, v in kern.parameters.items()}


def _inputs(rng):
    return (rng.standard_normal((7, D)), rng.standard_normal((5, D)),
            rng.standard_normal((7, 5)), rng.standard_normal((7, 7)),
            rng.standard_normal(7))


def _jax_eval(kern, values, X, X2, G, Gs, g):
    """K(X, X2), K(X), Kdiag(X), and the gradient of
    Σ K∘G + Σ K(X)∘Gs + Σ Kdiag∘g in every parameter and in X, X2."""
    def f(params, X, X2):
        p = {k: v[None] for k, v in params.items()}
        K = kern.K(X[None], X2[None], **p)[0]
        Ks = kern.K(X[None], **p)[0]
        Kd = kern.Kdiag(X[None], **p)[0]
        return jnp.sum(K * G) + jnp.sum(Ks * Gs) + jnp.sum(Kd * g), \
            (K, Ks, Kd)
    args = ({k: jnp.asarray(v) for k, v in values.items()},
            jnp.asarray(X), jnp.asarray(X2))
    (_, outs), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(*args)
    flat = dict(grads[0])
    flat["X"], flat["X2"] = grads[1], grads[2]
    return [np.asarray(o) for o in outs], \
        {k: np.asarray(v) for k, v in flat.items()}


def _torch_eval(kern, values, X, X2, G, Gs, g):
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in values.items()}
    Xt = torch.tensor(X, requires_grad=True)
    X2t = torch.tensor(X2, requires_grad=True)
    p = {k: v[None] for k, v in params.items()}
    K = kern.K(Xt[None], X2t[None], **p)[0]
    Ks = kern.K(Xt[None], **p)[0]
    Kd = kern.Kdiag(Xt[None], **p)[0]
    total = torch.sum(K * torch.as_tensor(G)) + \
        torch.sum(Ks * torch.as_tensor(Gs)) + \
        torch.sum(Kd * torch.as_tensor(g))
    total.backward()
    leaves = dict(params, X=Xt, X2=X2t)
    # an input a kernel ignores (Bias's X) has no gradient: JAX's is 0
    return [o.detach().numpy() for o in (K, Ks, Kd)], \
        {k: (np.zeros(v.shape) if v.grad is None else v.grad.numpy())
         for k, v in leaves.items()}


def _compare(jkern, tkern, seed):
    assert tkern.parameter_names == jkern.parameter_names
    rng = np.random.default_rng(seed)
    values = _param_values(jkern, rng)
    X, X2, G, Gs, g = _inputs(rng)
    jouts, jgrads = _jax_eval(jkern, values, X, X2, G, Gs, g)
    touts, tgrads = _torch_eval(tkern, values, X, X2, G, Gs, g)
    for name, a, b in zip(("K", "K(X)", "Kdiag"), touts, jouts):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    assert set(tgrads) == set(jgrads)
    for name in jgrads:
        np.testing.assert_allclose(tgrads[name], jgrads[name], rtol=RTOL,
                                   atol=ATOL, err_msg="d/d " + name)


@pytest.mark.parametrize("ard", [False, True], ids=["iso", "ard"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_jax(case, ard):
    _compare(CASES[case](jk, ard), CASES[case](tk, ard),
             sorted(CASES).index(case))


@pytest.mark.parametrize("case", sorted(STATIC))
def test_static_kernel_matches_jax(case):
    _compare(STATIC[case](jk), STATIC[case](tk), 100)


def test_white_is_zero_across_two_sets():
    kern = tk.White(2)
    v = {"white_variance": torch.full((1, 1), 0.7, dtype=torch.float64)}
    X = torch.randn(1, 4, 2, dtype=torch.float64)
    np.testing.assert_array_equal(kern.K(X, **v)[0].numpy(),
                                  0.7 * np.eye(4))
    assert not kern.K(X, X[:, :2], **v).any()


@pytest.mark.parametrize("cls", ["Matern12", "Matern32", "Matern52"])
def test_matern_gradient_finite_at_coincident_points(cls):
    """The clamp before the square root keeps the gradient at r = 0
    finite, in float32 and float64."""
    for dtype in (torch.float32, torch.float64):
        kern = getattr(tk, cls)(2, ARD=True)
        ls = torch.tensor([[0.8, 1.3]], dtype=dtype, requires_grad=True)
        var = torch.tensor([[1.1]], dtype=dtype, requires_grad=True)
        X = torch.tensor([[[0.3, -0.2], [0.3, -0.2], [1.0, 0.5]]],
                         dtype=dtype, requires_grad=True)
        K = kern.K(X, **{cls.lower() + "_lengthscale": ls,
                         cls.lower() + "_variance": var})
        K.sum().backward()
        for t in (ls, var, X):
            assert bool(torch.isfinite(t.grad).all()), (dtype, t.grad)


def test_kernel_exports_match_jax():
    names = [n for n in dir(jk) if not n.startswith("_")
             and isinstance(getattr(jk, n), type)]
    assert "MultiplyKernel" in names and "Polynomial" in names
    for n in names:
        assert isinstance(getattr(tk, n), type), n


def test_duplicate_sub_kernels_are_renamed():
    combo = tk.RBF(2) + tk.RBF(2) + tk.Linear(2)
    jcombo = jk.RBF(2) + jk.RBF(2) + jk.Linear(2)
    assert combo.parameter_names == jcombo.parameter_names
    assert "add_add_rbf_0_lengthscale" in combo.parameters
    assert "add_add_rbf_1_variance" in combo.parameters
    assert "add_linear_variances" in combo.parameters
    assert [k.name for k in combo.sub_kernels[0].sub_kernels] == \
        ["rbf_0", "rbf_1"]


def test_add_and_multiply_refuse_non_kernels():
    from mxfusion_tpu_torch.common.exceptions import ModelSpecificationError
    with pytest.raises(ModelSpecificationError):
        tk.RBF(2) + 1.0
    with pytest.raises(ModelSpecificationError):
        tk.RBF(2).multiply("rbf")


def test_replicate_self_maps_every_sub_kernel_parameter():
    combo = tk.RBF(2, ARD=True) * tk.Linear(2)
    amap = {v: v.replicate_self() for v in combo.parameters.values()}
    rep = combo.replicate_self(amap)
    assert rep is not combo and rep.sub_kernels[0] is not \
        combo.sub_kernels[0]
    assert rep.parameter_names == combo.parameter_names
    for name, v in combo.parameters.items():
        assert rep.parameters[name] is amap[v]
        assert rep.parameters[name].uuid == v.uuid
    single = tk.RBF(2)
    rep = single.replicate_self({single.lengthscale: Variable(shape=(1,))})
    assert rep.variance is single.variance
    assert rep.lengthscale is not single.lengthscale
