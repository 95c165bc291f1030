"""Exact GP regression (``GPRegression``) against the JAX package: the
log marginal likelihood, its gradients and the cached (X, L, LinvY); a
MAP trajectory; both predictions (diagonal and full covariance,
noise-free and noisy) and both sampling paths under shared draws; a
constant mean function and multi-output columns; the NaN convention;
the golden ``golden_gp_exact_1k.npz`` trajectory; serving through the
port's ``BatchedPredictor``; and carryover of a JAX-trained store.
float64 throughout; both packages start from the same state."""
import contextlib
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import mxfusion_tpu as mj
import mxfusion_tpu.components.distributions.gp.kernels as jk
from mxfusion_tpu.common import config as jconfig
from mxfusion_tpu.components.distributions import \
    FixedRandomGenerator as JFixed
from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive
from mxfusion_tpu import inference as jinference
from mxfusion_tpu.modules import GPRegression as JGPR
from mxfusion_tpu.modules.gp_modules import gp_regression as jgpr

import mxfusion_tpu_torch as mt
import mxfusion_tpu_torch.components.distributions.gp.kernels as tk
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.distributions import FixedRandomGenerator
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch import inference as tinference
from mxfusion_tpu_torch.modules import GPRegression
from mxfusion_tpu_torch.modules.gp_modules import gp_regression as tgpr
from mxfusion_tpu_torch.util.carryover import (carryover_params, load_state,
                                               name_paths)

J = SimpleNamespace(pkg=mj, k=jk, Positive=JPositive, GPR=JGPR, mod=jgpr,
                    inf=jinference, Fixed=JFixed)
T = SimpleNamespace(pkg=mt, k=tk, Positive=PositiveTransformation,
                    GPR=GPRegression, mod=tgpr, inf=tinference,
                    Fixed=FixedRandomGenerator)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "goldens", "golden_gp_exact_1k.npz")
KERNELS = {
    "rbf": lambda k, d: k.RBF(d, variance=1.3, lengthscale=0.9),
    "rbf_white": lambda k, d: (k.RBF(d, variance=1.3, lengthscale=0.9)
                               + k.White(d, variance=0.05)),
    "sum_active": lambda k, d: (
        k.RBF(2, ARD=True, active_dims=[0, 1], lengthscale=0.9)
        + k.Matern52(d, variance=0.5) + k.White(d, variance=0.05)),
    "product": lambda k, d: k.RBF(d, variance=1.3) * k.Linear(d),
}


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port runs on the card unless the CPU is asked for: these tests
    ask for it, and put the previous default back afterwards."""
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


@contextlib.contextmanager
def jax_f64():
    old = jconfig.get_default_dtype()
    jconfig.set_default_dtype("float64")
    try:
        yield
    finally:
        jconfig.set_default_dtype(old)


def _data(seed, N, D, D_out=1):
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 4
    Y = np.sin(2 * X[:, :1]) + 0.3 * np.cos(X[:, -1:] * np.arange(
        1, D_out + 1)) + 0.1 * rng.standard_normal((N, D_out))
    return X, Y


def _model(P, N_in, kernel="rbf", D_out=1, mean=None, noise=0.1,
           rand_gen=None, jitter=0.0):
    m = P.pkg.Model()
    m.N = P.pkg.Variable()
    m.X = P.pkg.Variable(shape=(m.N, N_in))
    if isinstance(noise, float):
        m.noise_var = P.pkg.Variable(transformation=P.Positive(),
                                     initial_value=noise)
    else:
        m.noise_var = P.pkg.Variable(value=noise[0])
    kw = {}
    if mean is not None:
        m.mean = P.pkg.Variable(value=mean)
        kw["mean"] = m.mean
    m.Y = P.GPR.define_variable(
        X=m.X, kernel=KERNELS[kernel](P.k, N_in), noise_var=m.noise_var,
        shape=(m.N, D_out), dtype="float64", rand_gen=rand_gen,
        jitter=jitter, **kw)
    return m


def _pair(X, Y, **kw):
    """The JAX MAP inference and the port's, loaded with the JAX state."""
    with jax_f64():
        jm = _model(J, X.shape[1], **kw)
        jinf = J.inf.GradBasedInference(
            J.inf.MAP(model=jm, observed=[jm.X, jm.Y]), dtype="float64")
        jinf.initialize(X=X, Y=Y, key=jax.random.PRNGKey(0))
    tm = _model(T, X.shape[1], **kw)
    tinf = T.inf.GradBasedInference(
        T.inf.MAP(model=tm, observed=[tm.X, tm.Y]), dtype="float64",
        device="cpu")
    tinf.initialize(X=X, Y=Y)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    return jinf, tinf


def _by_path(graphs, store):
    paths = name_paths(graphs)
    return {paths[k]: np.asarray(v.detach() if torch.is_tensor(v) else v)
            for k, v in store.items()}


def _loss_grads_aux(jinf, tinf, X, Y):
    """(loss, {path: gradient}, {path: aux}) of both packages."""
    jex = J.inf.create_executor(jinf.inference_algorithm, jinf.params)
    jfixed = dict(jinf.params.fixed_params())

    def jloss(tr):
        _, lg, aux = jex(tr, jfixed, [X, Y], jax.random.PRNGKey(0))
        return lg, aux
    with jax_f64():
        (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            dict(jinf.params.trainable_params()))
    ex = T.inf.create_executor(tinf.inference_algorithm, tinf.params)
    train = {k: v.clone().requires_grad_(True)
             for k, v in tinf.params.trainable_params().items()}
    _, tl, taux = ex(train, tinf.params.fixed_params(), [X, Y],
                     torch.Generator().manual_seed(0))
    tl.backward()
    return ((float(jl), _by_path(jinf.graphs, jg), _by_path(jinf.graphs,
                                                            jaux)),
            (float(tl.detach()),
             _by_path(tinf.graphs, {k: v.grad for k, v in train.items()}),
             _by_path(tinf.graphs, taux)))


# ---------------------------------------------------------------------
# the log marginal likelihood
# ---------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(kernel="rbf"), dict(kernel="rbf_white"),
    dict(kernel="sum_active"), dict(kernel="product"),
    dict(kernel="rbf", D_out=3), dict(kernel="rbf", mean=True)],
    ids=["rbf", "rbf_white", "sum_active", "product", "multi_output",
         "constant_mean"])
def test_log_pdf_gradients_and_cache_match_jax(case):
    """Loss 1e-9 relative; gradients and the cached (X, L, LinvY) rtol
    1e-6, atol 1e-8."""
    case = dict(case)
    X, Y = _data(1, 30, 3, case.get("D_out", 1))
    if case.pop("mean", False):
        case["mean"] = np.full((30, 1), 0.7)
        Y = Y + 0.7
    jinf, tinf = _pair(X, Y, **case)
    (jl, jg, jaux), (tl, tg, taux) = _loss_grads_aux(jinf, tinf, X, Y)
    assert abs(tl - jl) <= 1e-9 * abs(jl)
    assert set(tg) == set(jg) and len(tg) >= 3
    for path in jg:
        np.testing.assert_allclose(tg[path], jg[path], rtol=1e-6, atol=1e-8,
                                   err_msg=path)
    assert set(taux) == set(jaux) == {"Y.X", "Y.L", "Y.LinvY"}
    for path in jaux:
        np.testing.assert_allclose(taux[path], jaux[path], rtol=1e-6,
                                   atol=1e-8, err_msg=path)


def test_name_paths_of_a_sum_kernel():
    X, Y = _data(1, 12, 3)
    jinf, tinf = _pair(X, Y, kernel="rbf_white")
    want = {"Y.L", "Y.LinvY", "Y.X", "Y.add_rbf_lengthscale",
            "Y.add_rbf_variance", "Y.add_white_variance", "noise_var"}
    assert set(_by_path(jinf.graphs, jinf.params.param_dict)) == want
    assert set(_by_path(tinf.graphs, tinf.params.param_dict)) == want
    fixed = set(_by_path(tinf.graphs, {k: 0 for k in tinf.params.fixed}))
    assert fixed == {"Y.L", "Y.LinvY", "Y.X"}


def test_log_pdf_nan_as_jax():
    """Noise 0 and jitter 0 on inputs with two equal rows and a
    lengthscale 100 times the box: K is singular in both packages, the
    loss and the gradients are NaN and nothing raises."""
    X, Y = _data(2, 16, 2)
    X[1] = X[0]
    noise = (np.zeros(1),)
    jinf, tinf = _pair(X, Y, noise=noise)
    for inf in (jinf, tinf):
        kern = inf.graphs[0].Y.factor._module_graph.kernel
        inf.params[kern.lengthscale] = np.full(1, 400.0)
    (jl, jg, _), (tl, tg, _) = _loss_grads_aux(jinf, tinf, X, Y)
    assert np.isnan(jl) and np.isnan(tl)
    for path in jg:
        np.testing.assert_array_equal(np.isnan(tg[path]),
                                      np.isnan(jg[path]), err_msg=path)
    assert all(np.isnan(g).all() for g in tg.values())


# ---------------------------------------------------------------------
# training, predictions, sampling
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """Both packages train the same model for 15 MAP steps, each with its
    own loop, from the same start."""
    X, Y = _data(3, 40, 2)
    jinf, tinf = _pair(X, Y, kernel="rbf_white")
    jl, tl = [], []
    with jax_f64():
        jinf.run(max_iter=15, learning_rate=0.05, X=X, Y=Y,
                 key=jax.random.PRNGKey(0),
                 callback=lambda i, l: jl.append(float(l)))
    tinf.run(max_iter=15, learning_rate=0.05, X=X, Y=Y,
             callback=lambda i, l: tl.append(float(l)))
    Xt = np.random.default_rng(4).random((23, 2)) * 4
    return SimpleNamespace(X=X, Y=Y, Xt=Xt, jinf=jinf, tinf=tinf, jl=jl,
                           tl=tl)


def test_trajectory_and_trained_store_match_jax(trained):
    """Losses rtol 1e-6; every entry of the trained store, the
    prediction cache written back by the loop included, rtol 1e-5."""
    assert len(trained.tl) == len(trained.jl) == 15
    assert trained.tl[-1] < trained.tl[0]
    np.testing.assert_allclose(trained.tl, trained.jl, rtol=1e-6)
    jp = _by_path(trained.jinf.graphs, trained.jinf.params.param_dict)
    tp = _by_path(trained.tinf.graphs, trained.tinf.params.param_dict)
    assert set(tp) == set(jp)
    assert jp["Y.L"].shape == (40, 40) and np.abs(jp["Y.L"]).max() > 0
    for path in jp:
        np.testing.assert_allclose(tp[path], jp[path], rtol=1e-5, atol=1e-8,
                                   err_msg=path)


def _attach(model, alg):
    mod = model.Y.factor
    mod.attach_prediction_algorithms(
        targets=mod.output_names, conditionals=mod.input_names,
        algorithm=alg, alg_name="gp_predict")


def _predict(P, model, params, Xt, alg=None, num_samples=None, **run_kw):
    mod = model.Y.factor
    default = mod.gp_predict
    if alg is not None:
        _attach(model, alg)
    try:
        run = P.inf.TransferInference(P.inf.ModulePredictionAlgorithm(
            model=model, observed=[model.X], target_variables=[model.Y.uuid],
            num_samples=num_samples), infr_params=params)
        with jax_f64():
            out = run.run(X=Xt, **run_kw)[0]
    finally:
        _attach(model, default)
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


@pytest.mark.parametrize("noise_free", [True, False],
                         ids=["noise_free", "noisy"])
@pytest.mark.parametrize("diagonal", [True, False], ids=["diag", "full"])
def test_predictions_from_the_trained_store_match_jax(trained, diagonal,
                                                      noise_free):
    """Each package predicts from the store it trained itself: rtol 1e-6,
    atol 1e-9 (the stores agree to 1e-5 relative, the predictions far
    closer)."""
    outs = []
    for P, inf in ((J, trained.jinf), (T, trained.tinf)):
        model = inf.graphs[0]
        mod = model.Y.factor
        alg = P.mod.GPRegressionMeanVariancePrediction(
            mod._module_graph, mod._extra_graphs[0],
            [v for _, v in mod.inputs], noise_free=noise_free,
            diagonal_variance=diagonal)
        outs.append(_predict(P, model, inf.params, trained.Xt, alg))
    (jmu, jvar), (tmu, tvar) = outs
    assert tmu.shape == jmu.shape == (1, 23, 1)
    assert tvar.shape == jvar.shape == ((1, 23) if diagonal
                                        else (1, 23, 23))
    np.testing.assert_allclose(tmu, jmu, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tvar, jvar, rtol=1e-6, atol=1e-9)


def _carried(trained):
    """The JAX-trained store, carried into a fresh port model by name
    path (the prediction cache included)."""
    tm = _model(T, 2, kernel="rbf_white")
    state = {k: np.asarray(v) for k, v in
             trained.jinf.params.param_dict.items()}
    params = carryover_params(state, [tm], source_graphs=trained.jinf.graphs,
                              dtype="float64", device="cpu")
    return tm, params


def test_carryover_of_a_jax_trained_store_predicts_as_jax(trained):
    tm, params = _carried(trained)
    jm = trained.jinf.graphs[0]
    want = _predict(J, jm, trained.jinf.params, trained.Xt)
    got = _predict(T, tm, params, trained.Xt)
    assert len(params.param_dict) == 7
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kind", ["mean_variance", "full_covariance",
                                  "sampling"])
def test_batched_predictor_matches_jax(trained, kind):
    """50 rows through chunks of 16 (three full and a padded tail), from
    the carried-over store, against the JAX package's BatchedPredictor,
    with each prediction algorithm merged by its ``serving_data_axes``:
    the diagonal moments ((s, N, D) and (s, N)), the full covariance
    (block-diagonal (s, N, N)) and three predictive draws (s = 3; one
    chunk's worth of shared draws, which both servers reuse per chunk)."""
    tm, params = _carried(trained)
    jm = trained.jinf.graphs[0]
    Xt = np.linspace(0, 4, 100).reshape(50, 2)
    draws = np.random.default_rng(8).standard_normal(3 * 16)
    outs = []
    for P, model, p in ((J, jm, trained.jinf.params), (T, tm, params)):
        mod = model.Y.factor
        default = mod.gp_predict
        observed = [v for _, v in mod.inputs]
        if kind == "full_covariance":
            _attach(model, P.mod.GPRegressionMeanVariancePrediction(
                mod._module_graph, mod._extra_graphs[0], observed,
                noise_free=False, diagonal_variance=False))
        elif kind == "sampling":
            _attach(model, P.mod.GPRegressionSamplingPrediction(
                mod._module_graph, mod._extra_graphs[0], observed,
                rand_gen=P.Fixed(draws)))
        try:
            pred = P.inf.BatchedPredictor(
                model=model, infr_params=p, observed=[model.X],
                target_variables=[model.Y.uuid], chunk_size=16,
                num_samples=3 if kind == "sampling" else None)
            with jax_f64():
                out = pred.predict(X=Xt)[0]
        finally:
            _attach(model, default)
        outs.append([np.asarray(o) for o in (
            out if isinstance(out, tuple) else (out,))])
    shapes = {"mean_variance": [(1, 50, 1), (1, 50)],
              "full_covariance": [(1, 50, 1), (1, 50, 50)],
              "sampling": [(3, 50, 1)]}[kind]
    assert [o.shape for o in outs[1]] == shapes
    if kind == "full_covariance":
        assert outs[1][1][0, 0, 16] == 0.0  # cross-chunk blocks
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("diagonal", [True, False], ids=["diag", "full"])
def test_sampling_prediction_matches_jax(trained, diagonal):
    """Three predictive draws per point, the normal draws shared."""
    tm, params = _carried(trained)
    draws = np.random.default_rng(5).standard_normal(3 * 23)
    outs = []
    for P, model, p, kw in ((J, trained.jinf.graphs[0], trained.jinf.params,
                             {"key": jax.random.PRNGKey(0)}),
                            (T, tm, params, {})):
        mod = model.Y.factor
        alg = P.mod.GPRegressionSamplingPrediction(
            mod._module_graph, mod._extra_graphs[0],
            [v for _, v in mod.inputs], rand_gen=P.Fixed(draws),
            diagonal_variance=diagonal, noise_free=False, jitter=1e-8)
        outs.append(_predict(P, model, p, trained.Xt, alg, num_samples=3,
                             **kw)[0])
    assert outs[1].shape == outs[0].shape == (3, 23, 1)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-8, atol=1e-10)


def test_prior_sampling_matches_jax():
    """``draw_samples`` (``GPRegressionSampling``): four draws of Y at
    the inputs, the normal draws shared."""
    X, _ = _data(6, 20, 2)
    draws = np.random.default_rng(7).standard_normal(4 * 20)
    outs = []
    for P, kw in ((J, {"key": jax.random.PRNGKey(0)}), (T, {})):
        with jax_f64():
            m = _model(P, 2, kernel="rbf_white", rand_gen=P.Fixed(draws))
            alg = P.inf.ForwardSamplingAlgorithm(
                model=m, observed=[m.X], num_samples=4,
                target_variables=[m.Y.uuid])
            inf = P.inf.Inference(alg, dtype="float64", **(
                {"device": "cpu"} if P is T else {}))
            outs.append(np.asarray(inf.run(X=X, **kw)[0]))
    assert outs[1].shape == outs[0].shape == (4, 20, 1)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------
# the golden trajectory
# ---------------------------------------------------------------------

def test_golden_gp_exact_1k_reproduced():
    """tests/goldens/configs.py:113-137 through the port: N = 1000,
    D = 1, RBF, MAP + Adam at lr 0.02 for 50 steps, float64. rtol 1e-5,
    the golden's own."""
    golden = np.load(GOLDEN)["losses"]
    N = 1000
    rng = np.random.default_rng(2)
    X = rng.random((N, 1)) * 4
    y = np.sin(X[:, :1] * 2) + rng.standard_normal((N, 1)) * 0.1
    m = mt.Model()
    m.N = mt.Variable()
    m.X = mt.Variable(shape=(m.N, 1))
    m.noise_var = mt.Variable(transformation=PositiveTransformation(),
                              initial_value=0.1)
    m.Y = GPRegression.define_variable(
        X=m.X, kernel=tk.RBF(input_dim=1, variance=1.0, lengthscale=1.0,
                             dtype="float64"),
        noise_var=m.noise_var, shape=(m.N, 1), dtype="float64")
    infr = T.inf.GradBasedInference(T.inf.MAP(model=m, observed=[m.X, m.Y]),
                                    dtype="float64", device="cpu")
    losses = []
    infr.run(max_iter=50, learning_rate=0.02, X=X, Y=y,
             callback=lambda i, l: losses.append(float(l)))
    np.testing.assert_allclose(losses, golden, rtol=1e-5, atol=1e-8)
