"""Collapsed sparse GP regression (``SparseGPRegression``) against the
JAX package and against the independent ``titsias_neg_bound`` of
``tests/oracles/svgp_torch_oracle.py``: the bound and its gradients on
the narrow (N < 4M, triangular solves) and wide (N ≥ 4M, L⁻¹ applied as
a product) arms, the cached (L, LA, wv), both predictions, the sampling
prediction and ``draw_samples`` under shared draws, and carryover of a
JAX-trained store. float64 throughout."""
import contextlib
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
from mxfusion_tpu.modules import SparseGPRegression as JSGPR
from mxfusion_tpu.modules.gp_modules import sparsegp_regression as jsgpr

import mxfusion_tpu_torch as mt
import mxfusion_tpu_torch.components.distributions.gp.kernels as tk
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.distributions import FixedRandomGenerator
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch import inference as tinference
from mxfusion_tpu_torch.modules import SparseGPRegression
from mxfusion_tpu_torch.modules.gp_modules import sparsegp_regression as \
    tsgpr
from mxfusion_tpu_torch.util.carryover import (carryover_params, load_state,
                                               name_paths)

J = SimpleNamespace(pkg=mj, k=jk, Positive=JPositive, SGPR=JSGPR, mod=jsgpr,
                    inf=jinference, Fixed=JFixed)
T = SimpleNamespace(pkg=mt, k=tk, Positive=PositiveTransformation,
                    SGPR=SparseGPRegression, mod=tsgpr, inf=tinference,
                    Fixed=FixedRandomGenerator)
PATHS = {"Y.L", "Y.LA", "Y.wv", "Y.rbf_lengthscale", "Y.rbf_variance",
         "inducing_inputs", "noise_var"}


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


def _data(seed, N, D, M, D_out=1):
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 4
    Y = np.sin(2 * X[:, :1]) + 0.3 * np.cos(X[:, -1:] * np.arange(
        1, D_out + 1)) + 0.1 * rng.standard_normal((N, D_out))
    Z0 = rng.random((M, D)) * 4
    return X, Y, Z0


def _model(P, Z0, D_out=1, mean=None, rand_gen=None, jitter=1e-6):
    D = Z0.shape[1]
    m = P.pkg.Model()
    m.N = P.pkg.Variable()
    m.X = P.pkg.Variable(shape=(m.N, D))
    m.noise_var = P.pkg.Variable(transformation=P.Positive(),
                                 initial_value=0.1)
    kw = {}
    if mean is not None:
        m.mean = P.pkg.Variable(value=mean)
        kw["mean"] = m.mean
    m.Y = P.SGPR.define_variable(
        X=m.X, kernel=P.k.RBF(D, variance=1.3, lengthscale=0.9),
        noise_var=m.noise_var, shape=(m.N, D_out), dtype="float64",
        inducing_inputs=P.pkg.Variable(shape=Z0.shape, initial_value=Z0),
        rand_gen=rand_gen, jitter=jitter, **kw)
    return m


def _pair(X, Y, Z0, **kw):
    """The JAX MAP inference and the port's, loaded with the JAX state."""
    with jax_f64():
        jm = _model(J, Z0, **kw)
        jinf = J.inf.GradBasedInference(
            J.inf.MAP(model=jm, observed=[jm.X, jm.Y]), dtype="float64")
        jinf.initialize(X=X, Y=Y, key=jax.random.PRNGKey(0))
    tm = _model(T, Z0, **kw)
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
# the bound
# ---------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(N=30), dict(N=64), dict(N=30, D_out=2), dict(N=30, mean=True)],
    ids=["narrow", "wide", "multi_output", "constant_mean"])
def test_bound_gradients_and_cache_match_jax(case):
    """M = 8 inducing points: N = 30 takes the triangular solves, N = 64
    (≥ 4M) the materialized L⁻¹. Loss 1e-9 relative; gradients and the
    cached (L, LA, wv) rtol 1e-6, atol 1e-8."""
    case = dict(case)
    N = case.pop("N")
    X, Y, Z0 = _data(1, N, 2, 8, case.get("D_out", 1))
    if case.pop("mean", False):
        case["mean"] = np.full((N, 1), 0.7)
        Y = Y + 0.7
    jinf, tinf = _pair(X, Y, Z0, **case)
    (jl, jg, jaux), (tl, tg, taux) = _loss_grads_aux(jinf, tinf, X, Y)
    assert abs(tl - jl) <= 1e-9 * abs(jl)
    assert set(tg) == set(jg) == {"Y.rbf_lengthscale", "Y.rbf_variance",
                                  "inducing_inputs", "noise_var"}
    for path in jg:
        np.testing.assert_allclose(tg[path], jg[path], rtol=1e-6, atol=1e-8,
                                   err_msg=path)
    assert set(taux) == set(jaux) == {"Y.L", "Y.LA", "Y.wv"}
    for path in jaux:
        np.testing.assert_allclose(taux[path], jaux[path], rtol=1e-6,
                                   atol=1e-8, err_msg=path)


@pytest.mark.parametrize("N", [30, 64], ids=["narrow", "wide"])
def test_bound_matches_the_independent_oracle(N):
    """``titsias_neg_bound`` writes the bound as log N(y | 0, Qnn + σ²I)
    − tr(Knn − Qnn)/(2σ²) through the Woodbury core, in plain torch:
    value and gradients (by autograd through the oracle) rtol 1e-9."""
    X, Y, Z0 = _data(2, N, 2, 8)
    jinf, tinf = _pair(X, Y, Z0)
    raw = _by_path(tinf.graphs, tinf.params.param_dict)
    old = torch.get_default_dtype()
    try:
        # importing the oracle sets torch's default dtype to float64,
        # which it needs; the previous default comes back afterwards
        from oracles import svgp_torch_oracle as oracle
        torch.set_default_dtype(torch.float64)
        params = {"raw_noise": raw["noise_var"],
                  "raw_variance": raw["Y.rbf_variance"],
                  "raw_lengthscale": raw["Y.rbf_lengthscale"],
                  "Z": raw["inducing_inputs"]}
        params = {k: torch.tensor(v, requires_grad=True)
                  for k, v in params.items()}
        want = oracle.titsias_neg_bound(params, torch.tensor(X),
                                        torch.tensor(Y), jitter=1e-6)
        want.backward()
    finally:
        torch.set_default_dtype(old)
    _, (tl, tg, _) = _loss_grads_aux(jinf, tinf, X, Y)
    np.testing.assert_allclose(tl, float(want.detach()), rtol=1e-9)
    for path, key in (("noise_var", "raw_noise"),
                      ("Y.rbf_variance", "raw_variance"),
                      ("Y.rbf_lengthscale", "raw_lengthscale"),
                      ("inducing_inputs", "Z")):
        np.testing.assert_allclose(tg[path], params[key].grad.numpy(),
                                   rtol=1e-9, atol=1e-11, err_msg=path)


# ---------------------------------------------------------------------
# training, predictions, sampling
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """The JAX package trains for 15 MAP steps; the port's store is the
    JAX-trained one, carried over by name path (caches included). The
    port also trains from the same start, for the trajectory."""
    X, Y, Z0 = _data(3, 48, 2, 10)
    jinf, tinf = _pair(X, Y, Z0)
    jl, tl = [], []
    with jax_f64():
        jinf.run(max_iter=15, learning_rate=0.05, X=X, Y=Y,
                 key=jax.random.PRNGKey(0),
                 callback=lambda i, l: jl.append(float(l)))
    tinf.run(max_iter=15, learning_rate=0.05, X=X, Y=Y,
             callback=lambda i, l: tl.append(float(l)))
    tm = _model(T, Z0)
    params = carryover_params(
        {k: np.asarray(v) for k, v in jinf.params.param_dict.items()},
        [tm], source_graphs=jinf.graphs, dtype="float64", device="cpu")
    Xt = np.random.default_rng(4).random((21, 2)) * 4
    return SimpleNamespace(X=X, Y=Y, Xt=Xt, jinf=jinf, tinf=tinf, jl=jl,
                           tl=tl, tm=tm, params=params)


def test_trajectory_and_carryover_match_jax(trained):
    """Losses rtol 1e-6 and the port's own trained store (its cache
    written back by the loop) rtol 1e-5; the carried store holds every
    JAX entry by name path, bit for bit."""
    np.testing.assert_allclose(trained.tl, trained.jl, rtol=1e-6)
    assert trained.tl[-1] < trained.tl[0]
    jp = _by_path(trained.jinf.graphs, trained.jinf.params.param_dict)
    tp = _by_path(trained.tinf.graphs, trained.tinf.params.param_dict)
    assert set(jp) == set(tp) == PATHS
    for path in jp:
        np.testing.assert_allclose(tp[path], jp[path], rtol=1e-5, atol=1e-8,
                                   err_msg=path)
    carried = _by_path([trained.tm], trained.params.param_dict)
    for path in jp:
        np.testing.assert_array_equal(carried[path], jp[path])


def _predict(P, model, params, Xt, alg=None, num_samples=None, **run_kw):
    mod = model.Y.factor
    default = mod.sgp_predict

    def attach(a):
        mod.attach_prediction_algorithms(
            targets=mod.output_names, conditionals=mod.input_names,
            algorithm=a, alg_name="sgp_predict")
    if alg is not None:
        attach(alg)
    try:
        run = P.inf.TransferInference(P.inf.ModulePredictionAlgorithm(
            model=model, observed=[model.X], target_variables=[model.Y.uuid],
            num_samples=num_samples), infr_params=params)
        with jax_f64():
            out = run.run(X=Xt, **run_kw)[0]
    finally:
        attach(default)
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


@pytest.mark.parametrize("noise_free", [True, False],
                         ids=["noise_free", "noisy"])
@pytest.mark.parametrize("diagonal", [True, False], ids=["diag", "full"])
def test_predictions_match_jax(trained, diagonal, noise_free):
    """From the carried-over store: rtol 1e-9, atol 1e-11."""
    outs = []
    for P, model, params in ((J, trained.jinf.graphs[0],
                              trained.jinf.params),
                             (T, trained.tm, trained.params)):
        mod = model.Y.factor
        alg = P.mod.SparseGPRegressionMeanVariancePrediction(
            mod._module_graph, mod._extra_graphs[0],
            [v for _, v in mod.inputs], noise_free=noise_free,
            diagonal_variance=diagonal)
        outs.append(_predict(P, model, params, trained.Xt, alg))
    (jmu, jvar), (tmu, tvar) = outs
    assert tmu.shape == (1, 21, 1)
    assert tvar.shape == jvar.shape == ((1, 21) if diagonal
                                        else (1, 21, 21))
    np.testing.assert_allclose(tmu, jmu, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(tvar, jvar, rtol=1e-9, atol=1e-11)


def test_port_trained_store_predicts_as_jax(trained):
    """The default prediction from the store the port trained itself
    (the loop's cache write-back): rtol 1e-5, atol 1e-8."""
    jmu, jvar = _predict(J, trained.jinf.graphs[0], trained.jinf.params,
                         trained.Xt)
    tmu, tvar = _predict(T, trained.tinf.graphs[0], trained.tinf.params,
                         trained.Xt)
    np.testing.assert_allclose(tmu, jmu, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(tvar, jvar, rtol=1e-5, atol=1e-8)


def test_batched_predictor_matches_jax(trained):
    Xt = np.linspace(0, 4, 70).reshape(35, 2)
    outs = []
    for P, model, params in ((J, trained.jinf.graphs[0],
                              trained.jinf.params),
                             (T, trained.tm, trained.params)):
        pred = P.inf.BatchedPredictor(
            model=model, infr_params=params, observed=[model.X],
            target_variables=[model.Y.uuid], chunk_size=16)
        with jax_f64():
            outs.append([np.asarray(o) for o in pred.predict(X=Xt)[0]])
    for a, b in zip(outs[1], outs[0]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("diagonal", [True, False], ids=["diag", "full"])
def test_sampling_prediction_matches_jax(trained, diagonal):
    draws = np.random.default_rng(5).standard_normal(3 * 21)
    outs = []
    for P, model, params, kw in ((J, trained.jinf.graphs[0],
                                  trained.jinf.params,
                                  {"key": jax.random.PRNGKey(0)}),
                                 (T, trained.tm, trained.params, {})):
        mod = model.Y.factor
        alg = P.mod.SparseGPRegressionSamplingPrediction(
            mod._module_graph, mod._extra_graphs[0],
            [v for _, v in mod.inputs], rand_gen=P.Fixed(draws),
            diagonal_variance=diagonal, noise_free=False, jitter=1e-8)
        outs.append(_predict(P, model, params, trained.Xt, alg,
                             num_samples=3, **kw)[0])
    assert outs[1].shape == outs[0].shape == (3, 21, 1)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-8, atol=1e-10)


def test_draw_samples_matches_jax(trained):
    """``draw_samples`` is forward sampling of the module graph (U from
    its GP prior, F from the conditional GP, Y from the likelihood),
    each draw shared."""
    X = trained.X[:12]
    draws = np.random.default_rng(6).standard_normal(4 * (10 + 12 + 12))
    outs = []
    for P, params, kw in ((J, trained.jinf.params,
                           {"key": jax.random.PRNGKey(0)}),
                          (T, trained.params, {})):
        with jax_f64():
            m = _model(P, np.zeros((10, 2)), rand_gen=P.Fixed(draws))
            paths = {p: u for u, p in name_paths([m]).items()}
            src = _by_path(trained.jinf.graphs, trained.jinf.params
                           .param_dict)
            alg = P.inf.ForwardSamplingAlgorithm(
                model=m, observed=[m.X], num_samples=4,
                target_variables=[m.Y.uuid])
            inf = P.inf.Inference(alg, dtype="float64", **(
                {"device": "cpu"} if P is T else {}))
            inf.initialize(X=X, **kw)
            for path, value in src.items():
                if path in paths and paths[path] in inf.params.param_dict:
                    inf.params.param_dict[paths[path]] = (
                        torch.as_tensor(np.array(value)) if P is T else value)
            outs.append(np.asarray(inf.run(X=X, **kw)[0]))
    assert outs[1].shape == outs[0].shape == (4, 12, 1)
    assert np.isfinite(outs[1]).all()
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-8, atol=1e-10)
