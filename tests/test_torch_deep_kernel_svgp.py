"""Deep-kernel SVGP regression against the JAX package, float64 on the
CPU: a feature network (3 → 8 → tanh → 2) in front of
``SVGPRegression`` (RBF, M = 4, a learned noise variance), after
``tests/modules/test_deep_kernel_svgp.py``.

Both packages start from one state: the JAX package initializes it
(flax's weights included), q(U) is moved off its initial value, and
``util.carryover.load_state`` moves it into the port's store by name
path. The bound and the gradient of every network weight, of Z and of
the kernel's and the noise's parameters agree at rtol 1e-10 on the
narrow (N < 4M) and the wide (N >= 4M) branch. On the wide branch the
port's fused arm, forced on here, runs the plain version of K2/K3,
whose dXs is the network's gradient. Then a few MAP steps, a network of
``nn.Linear`` layers carried through ``linear_stack_map``, and
``BatchedPredictor`` with the raw inputs observed, exported and served
in a process that builds no model."""
import jax
import numpy as np
import pytest
import torch

from mxfusion_tpu.components.functions import FlaxFunction
from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive
from mxfusion_tpu_torch.components.functions import NNFunction
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.ops import fused_gram
from mxfusion_tpu_torch.util.carryover import (apply_param_map,
                                               linear_stack_map, load_state,
                                               name_paths)

from tests.test_torch_export import serve_in_subprocess
from tests.test_torch_nn_function import FlaxMLP, MLP
from tests.test_torch_svgp_classification import (
    J, T, RTOL, by_path, jax_f64, loss_and_grads, _on_the_cpu)  # noqa: F401

M, F, H, D_IN = 4, 2, 8, 3


def build(P, n_example, net=None, Z0=None):
    """The deep-kernel model of package P: ``X_raw`` (n, 3) → the
    feature net → ``SVGPRegression`` over the features."""
    m = P.pkg.Model()
    m.n = P.pkg.Variable()
    m.X_raw = P.pkg.Variable(shape=(m.n, D_IN))
    if P is J:
        f = FlaxFunction(FlaxMLP((D_IN, H, F)), name="feat",
                         input_shapes=[(n_example, D_IN)],
                         rng_key=jax.random.PRNGKey(0), dtype="float64")
    else:
        torch.manual_seed(0)
        f = NNFunction(net if net is not None else MLP((D_IN, H, F)),
                       name="feat", input_shapes=[(n_example, D_IN)],
                       dtype="float64", device="cpu")
    m.features = f(m.X_raw)
    m.noise_var = P.pkg.Variable(
        transformation=JPositive() if P is J else PositiveTransformation(),
        initial_value=0.05)
    m.Y = P.modules.SVGPRegression.define_variable(
        X=m.features, kernel=P.rbf(input_dim=F, variance=1.3,
                                   lengthscale=0.9, dtype="float64"),
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=P.pkg.Variable(shape=(M, F), initial_value=Z0),
        dtype="float64")
    return m


def data(seed, N):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D_IN))
    y = np.sin(X @ np.array([1.0, -2.0, 0.5]))[:, None] + \
        0.1 * rng.standard_normal((N, 1))
    Z0 = rng.standard_normal((M, F)) * 0.5
    return X, y, Z0


def inference(P, m, **kw):
    extra = {} if P is J else {"device": "cpu"}
    return P.inf.GradBasedInference(
        P.inf.MAP(model=m, observed=[m.X_raw, m.Y]), dtype="float64",
        **extra, **kw)


def pair(N, seed=0, net=None, param_map=None):
    """The JAX and the port inference at one state: JAX's initial one
    with q(U) moved by seeded draws."""
    X, Y, Z0 = data(seed, N)
    with jax_f64():
        jm = build(J, N, Z0=Z0)
        jinf = inference(J, jm)
        jinf.initialize(X_raw=X, Y=Y, key=jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed + 100)
        state = by_path(jinf.graphs, jinf.params.param_dict)
        state["Y.qU_mean"] = rng.standard_normal((M, 1)) * 0.5
        state["Y.qU_cov_W"] = rng.standard_normal((M, M)) * 0.2 + np.eye(M)
        state["Y.qU_cov_diag"] = rng.uniform(-5.0, -3.0, M)
        jpaths = {p: u for u, p in name_paths(jinf.graphs).items()}
        jinf.params.update_params(
            {jpaths[p]: jax.numpy.asarray(v) for p, v in state.items()})
    tm = build(T, N, net=net, Z0=Z0)
    tinf = inference(T, tm)
    tinf.initialize(X_raw=X, Y=Y)
    load_state(tinf.params, state, tinf.graphs, param_map=param_map)
    return jinf, tinf, [X, Y]


NET_PATHS = {"features.feat_Dense_0_kernel", "features.feat_Dense_0_bias",
             "features.feat_Dense_1_kernel", "features.feat_Dense_1_bias"}


@pytest.fixture(params=["plain", "fused"])
def arm(request, monkeypatch):
    """``fused``: the fused arm forced on on the CPU (its gate wants a
    CUDA tensor), running K2/K3's plain version."""
    if request.param == "fused":
        monkeypatch.setattr(fused_gram, "supported", lambda *a: True)
    return request.param


@pytest.mark.parametrize("width", ["narrow", "wide"])
def test_bound_and_every_gradient_match_jax(width, arm, monkeypatch):
    N = 12 if width == "narrow" else 24   # 4M = 16
    jinf, tinf, batch = pair(N)
    used = []
    apply = fused_gram._FusedLinvRbfGram.apply
    monkeypatch.setattr(fused_gram._FusedLinvRbfGram, "apply",
                        lambda *a: used.append(1) or apply(*a))
    (jl, jg), (tl, tg) = loss_and_grads(jinf, tinf, batch)
    assert bool(used) == (arm == "fused" and width == "wide")
    assert np.isfinite(jl)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert set(tg) == set(jg)
    assert NET_PATHS | {"inducing_inputs", "noise_var", "Y.rbf_lengthscale",
                        "Y.rbf_variance", "Y.qU_mean", "Y.qU_cov_W",
                        "Y.qU_cov_diag"} == set(tg)
    for path in jg:
        assert np.abs(jg[path]).max() > 0, path
        np.testing.assert_allclose(tg[path], jg[path], rtol=RTOL,
                                   atol=RTOL * np.abs(jg[path]).max(),
                                   err_msg=path)


def test_map_steps_match_jax():
    """Five Adam steps from the same state: the losses and the trained
    network weights, rtol 1e-10."""
    jinf, tinf, (X, Y) = pair(24, seed=1)
    jl, tl = [], []
    with jax_f64():
        jinf.run(max_iter=5, learning_rate=0.01, X_raw=X, Y=Y,
                 callback=lambda i, l: jl.append(float(l)))
    tinf.run(max_iter=5, learning_rate=0.01, X_raw=X, Y=Y,
             callback=lambda i, l: tl.append(float(l)))
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    jstate = by_path(jinf.graphs, jinf.params.param_dict)
    tstate = by_path(tinf.graphs, tinf.params.param_dict)
    for path in NET_PATHS:
        np.testing.assert_allclose(tstate[path], jstate[path], rtol=1e-9,
                                   atol=1e-12, err_msg=path)


def test_linear_layers_carry_across_through_the_map():
    """A port network of ``nn.Linear`` layers (weight (out, in)) gets the
    JAX package's Dense kernels through ``linear_stack_map``, transposed,
    and gives JAX's bound and, mapped back, its network gradients."""
    torch.manual_seed(0)
    seq = torch.nn.Sequential(torch.nn.Linear(D_IN, H), torch.nn.Tanh(),
                              torch.nn.Linear(H, F)).double()
    pmap = linear_stack_map("feat", seq)
    assert pmap == {"feat_Dense_0_kernel": ("feat_0_weight", True),
                    "feat_Dense_0_bias": ("feat_0_bias", False),
                    "feat_Dense_1_kernel": ("feat_2_weight", True),
                    "feat_Dense_1_bias": ("feat_2_bias", False)}
    jinf, tinf, batch = pair(24, net=seq, param_map=pmap)
    (jl, jg), (tl, tg) = loss_and_grads(jinf, tinf, batch)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    back = {v[0]: (k, v[1]) for k, v in pmap.items()}
    tg = apply_param_map(tg, back)
    assert set(tg) == set(jg)
    for path in NET_PATHS:
        np.testing.assert_allclose(tg[path], jg[path], rtol=RTOL,
                                   atol=RTOL * np.abs(jg[path]).max(),
                                   err_msg=path)


def test_batched_predictor_serves_the_raw_inputs(tmp_path):
    """``BatchedPredictor`` with ``X_raw`` observed evaluates the network
    on each chunk and predicts from its features, as JAX's does; the
    exported graph, network and all, serves in a process that never
    imports the network's class (nor JAX), equal to the live port
    predictor to the bit and to JAX's at 1e-10."""
    jinf, tinf, _ = pair(24, seed=2)
    Xt = np.random.default_rng(3).standard_normal((37, D_IN))
    outs = []
    for P, inf in ((J, jinf), (T, tinf)):
        m = inf.graphs[0]
        with jax_f64():
            pred = P.inf.BatchedPredictor(
                model=m, infr_params=inf.params, observed=[m.X_raw],
                target_variables=[m.Y.uuid], chunk_size=16)
            outs.append([np.asarray(a) for a in
                         pred.predict(X_raw=Xt)[0]])
    for got, want in zip(outs[1], outs[0]):
        assert got.shape == (1, 37, 1)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)
    path = str(tmp_path / "deep_kernel.zip")
    pred.export(path)
    served = serve_in_subprocess(path, X_raw=Xt)
    for got, live, want in zip(served, outs[1], outs[0]):
        np.testing.assert_array_equal(got, live)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)
