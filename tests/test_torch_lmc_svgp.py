"""``LMCSVGPRegression`` against the JAX package: the closed-form mixed
bound and its gradient in every parameter (standard and whitened, a
scalar and a per-output noise variance, both solve arms), both
predictions (``noise_free`` True and False, the diagonal and the full
cross-output covariance), forward draws on the same normals, a carried
JAX state, the default mixing matrix and inducing inputs, and the golden
``golden_lmc_multioutput.npz`` trajectory. float64, rtol 1e-10.
"""
import jax
import numpy as np
import pytest
import torch

from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive
from mxfusion_tpu.modules.gp_modules import lmc_svgp as jlmc

from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.modules.gp_modules import lmc_svgp as tlmc
from mxfusion_tpu_torch.util.carryover import (carryover_params, load_state,
                                               name_paths)

from tests.test_torch_svgp_classification import (
    GOLDEN, J, T, RTOL, assert_same_bound, by_path, jax_f64, serve)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


GOLDEN_LMC = GOLDEN.replace("golden_svgp_classification",
                            "golden_lmc_multioutput")
C, Q = 3, 2
POSITIVE = {"jax": JPositive, "torch": PositiveTransformation}


def build(P, Z0, noise="scalar", fixed=None, variance=1.3,
          lengthscale=0.9, **kw):
    """An LMC model over X with C outputs and Q latents; a trainable
    noise variance, scalar or per-output (``noise``), a seeded mixing
    matrix, and ``fixed`` as the module's random generator."""
    D = Z0.shape[1]
    pos = POSITIVE["jax" if P is J else "torch"]
    m = P.pkg.Model()
    m.n = P.pkg.Variable()
    m.X = P.pkg.Variable(shape=(m.n, D))
    nv = np.array([0.05]) if noise == "scalar" \
        else np.array([0.05, 0.2, 0.1])
    m.noise_var = P.pkg.Variable(shape=nv.shape, transformation=pos(),
                                 initial_value=nv)
    W0 = np.random.default_rng(17).standard_normal((Q, C))
    kw["mixing_matrix"] = P.pkg.Variable(shape=(Q, C), initial_value=W0)
    if fixed is not None:
        kw["rand_gen"] = P.Fixed(fixed)
    m.Y = P.modules.LMCSVGPRegression.define_variable(
        X=m.X, kernel=P.rbf(input_dim=D, variance=variance,
                            lengthscale=lengthscale, dtype="float64"),
        num_outputs=C, num_latents=Q, shape=(m.n, C),
        noise_var=m.noise_var,
        inducing_inputs=P.pkg.Variable(shape=Z0.shape, initial_value=Z0),
        dtype="float64", **kw)
    return m


def moved(state, seed):
    """q(U) moved off its initial value by seeded draws."""
    rng = np.random.default_rng(seed)
    M = state["Y.qU_mean"].shape[0]
    state["Y.qU_mean"] = rng.standard_normal((M, Q)) * 0.5
    state["Y.qU_cov_W"] = rng.standard_normal((M, M)) * 0.2 + np.eye(M)
    state["Y.qU_cov_diag"] = rng.uniform(-5.0, -3.0, M)
    return state


def pair(X, Y, Z0, **kw):
    """The JAX MAP inference and the port's at one state: JAX's initial
    state with q(U) moved by seeded draws."""
    with jax_f64():
        jm = build(J, Z0, **kw)
        jinf = J.inf.GradBasedInference(
            J.inf.MAP(model=jm, observed=[jm.X, jm.Y]), dtype="float64")
        jinf.initialize(X=X, Y=Y, key=jax.random.PRNGKey(0))
        state = moved(by_path(jinf.graphs, jinf.params.param_dict), 0)
        jpaths = {p: u for u, p in name_paths(jinf.graphs).items()}
        jinf.params.update_params(
            {jpaths[p]: jax.numpy.asarray(v) for p, v in state.items()})
    tm = build(T, Z0, **kw)
    tinf = T.inf.GradBasedInference(
        T.inf.MAP(model=tm, observed=[tm.X, tm.Y]), dtype="float64",
        device="cpu")
    tinf.initialize(X=X, Y=Y)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    return jinf, tinf


def data(seed, N, M, D=2):
    """Outputs mixed from two latent functions of X plus noise."""
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 4
    G = np.stack([np.sin(X[:, 0]), np.cos(1.3 * X[:, 1])], -1)
    Y = G @ rng.standard_normal((Q, C)) + 0.1 * rng.standard_normal((N, C))
    return X, Y, rng.random((M, D)) * 4, rng


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("noise", ["scalar", "per_output"])
@pytest.mark.parametrize("whitened", [False, True],
                         ids=["standard", "whitened"])
def test_bound_and_gradients_match_jax(whitened, noise, width):
    """N < 4M solves, N ≥ 4M takes L⁻¹ (or the wide solve, whitened).
    The loss and all eight gradients (Z, the kernel's two, q(U)'s three,
    the noise and the mixing matrix) at rtol 1e-10."""
    M = 6
    N = 18 if width == "narrow" else 48
    X, Y, Z0, _ = data(1, N, M)
    jinf, tinf = pair(X, Y, Z0, whitened=whitened, noise=noise,
                      jitter=1e-4)
    assert_same_bound(jinf, tinf, [X, Y], 8)


def _full_cov_prediction(P, inf, noise_free):
    """Replace the module's prediction with the full-output-covariance
    one (as ``lmc_svgp_predict``, so serving takes it)."""
    mod = inf.graphs[0].Y.factor
    alg = P.modules.gp_modules.lmc_svgp.LMCSVGPMeanVariancePrediction(
        mod._module_graph, mod._extra_graphs[0], [v for _, v in mod.inputs],
        noise_free=noise_free, full_output_cov=True, jitter=mod.jitter,
        whitened=mod.whitened)
    mod.attach_prediction_algorithms(
        targets=mod.output_names, conditionals=mod.input_names,
        algorithm=alg, alg_name="lmc_svgp_predict")


@pytest.mark.parametrize("full_output_cov", [False, True],
                         ids=["diagonal", "full_output_cov"])
@pytest.mark.parametrize("noise_free", [True, False])
def test_predictions_match_jax(noise_free, full_output_cov):
    """Both ``BatchedPredictor``s over 100 rows in chunks of 64 (a padded
    tail), per-output noise: the mean (1, N, C) and the variance
    (1, N, C) or the covariance (1, N, C, C), rtol 1e-10."""
    X, Y, Z0, rng = data(2, 30, 7)
    Xt = rng.random((100, 2)) * 4
    jinf, tinf = pair(X, Y, Z0, noise="per_output", jitter=1e-4)
    for P, inf in ((J, jinf), (T, tinf)):
        if full_output_cov:
            _full_cov_prediction(P, inf, noise_free)
        elif not noise_free:
            inf.graphs[0].Y.factor.lmc_svgp_predict.noise_free = False
    jout, tout = serve(jinf, tinf, Xt)
    shape = (1, 100, C, C) if full_output_cov else (1, 100, C)
    assert tout[0].shape == (1, 100, C) and tout[1].shape == shape
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-14)
    if full_output_cov:
        # the diagonal is the diagonal path's variance
        _, diag = pair(X, Y, Z0, noise="per_output", jitter=1e-4)
        if not noise_free:
            diag.graphs[0].Y.factor.lmc_svgp_predict.noise_free = False
        _, dout = serve(jinf, diag, Xt)
        np.testing.assert_allclose(np.diagonal(tout[1], axis1=-2, axis2=-1),
                                   dout[1], rtol=1e-12)


def test_forward_draws_match_jax():
    """U (M, Q) → F (N, Q) → Y ~ N(F·W, σ²) by forward sampling of the
    module graph on the same fixed normals."""
    X, _, Z0, rng = data(3, 9, 5)
    draws = 3
    noise = rng.standard_normal(draws * (5 * Q + 9 * Q + 9 * C))
    with jax_f64():
        jm = build(J, Z0, fixed=noise)
        jinf = J.inf.Inference(J.inf.ForwardSamplingAlgorithm(
            model=jm, observed=[jm.X], num_samples=draws,
            target_variables=[jm.Y.uuid]), dtype="float64")
        jinf.initialize(X=X, key=jax.random.PRNGKey(0))
        (jy,) = jinf.run(X=X, key=jax.random.PRNGKey(0))
    tm = build(T, Z0, fixed=noise)
    tinf = T.inf.Inference(T.inf.ForwardSamplingAlgorithm(
        model=tm, observed=[tm.X], num_samples=draws,
        target_variables=[tm.Y.uuid]), dtype="float64", device="cpu")
    tinf.initialize(X=X)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    (ty,) = tinf.run(X=X, generator=torch.Generator().manual_seed(0))
    assert ty.shape == (draws, 9, C)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=1e-12)


def test_carried_state_gives_the_same_bound():
    """A JAX state trained by 10 MAP steps, carried by name path into a
    fresh port model: the mixing matrix and the per-output noise among
    the paths, and the same bound."""
    X, Y, Z0, _ = data(4, 30, 6)
    with jax_f64():
        jm = build(J, Z0, noise="per_output")
        jinf = J.inf.GradBasedInference(
            J.inf.MAP(model=jm, observed=[jm.X, jm.Y]), dtype="float64")
        jinf.run(X=X, Y=Y, max_iter=10, learning_rate=0.05,
                 key=jax.random.PRNGKey(2))
    state = by_path(jinf.graphs, jinf.params.param_dict)
    assert set(state) == {"inducing_inputs", "noise_var", "mixing_matrix",
                          "Y.qU_mean", "Y.qU_cov_W", "Y.qU_cov_diag",
                          "Y.rbf_lengthscale", "Y.rbf_variance"}
    tm = build(T, Z0, noise="per_output")
    params = carryover_params(state, [tm], dtype="float64", device="cpu")
    tinf = T.inf.GradBasedInference(
        T.inf.MAP(model=tm, observed=[tm.X, tm.Y]), dtype="float64",
        device="cpu")
    tinf.initialize(X=X, Y=Y)
    tinf.params.update_params(params.param_dict)
    assert_same_bound(jinf, tinf, [X, Y], 8)


def test_default_mixing_matrix_and_inducing_inputs_are_jax():
    """Without them, the mixing matrix is the QR of a
    ``default_rng(0)`` draw and the inducing inputs come from the global
    ``np.random``: at one global seed both packages start alike."""
    starts = []
    for P in (J, T):
        np.random.seed(5)
        mod = P.modules.LMCSVGPRegression(
            X=np.zeros((4, 2)), kernel=P.rbf(input_dim=2),
            num_outputs=4, num_latents=3, num_inducing=6)
        starts.append((np.asarray(mod.mixing_matrix.initial_value),
                       np.asarray(mod.inducing_inputs.initial_value)))
    (jw, jz), (tw, tz) = starts
    assert tw.shape == (3, 4) and tz.shape == (6, 2)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tz, jz)
    np.testing.assert_allclose(tw @ tw.T, np.eye(3), atol=1e-12)
    for P, lmc in ((J, jlmc), (T, tlmc)):
        with pytest.raises(ValueError):
            P.modules.LMCSVGPRegression(X=np.zeros((4, 2)),
                                        kernel=P.rbf(input_dim=2),
                                        num_outputs=0)
        assert lmc.LMCSVGPRegression is P.modules.LMCSVGPRegression


def test_replicated_module_gives_the_same_bound():
    """``model.clone()`` replicates the module (kernel, mixing, latents):
    the clone, given the original's state, has the same bound."""
    X, Y, Z0, _ = data(5, 20, 5)
    jinf, tinf = pair(X, Y, Z0, noise="per_output")
    clone = tinf.graphs[0].clone()
    cinf = T.inf.GradBasedInference(
        T.inf.MAP(model=clone, observed=[clone.X, clone.Y]),
        dtype="float64", device="cpu")
    cinf.initialize(X=X, Y=Y)
    load_state(cinf.params, by_path(tinf.graphs, tinf.params.param_dict),
               cinf.graphs)
    rep = clone.Y.factor
    assert (rep.num_outputs, rep.num_latents) == (C, Q)
    assert_same_bound(jinf, cinf, [X, Y], 8)


def test_golden_lmc_multioutput_reproduced():
    """tests/goldens/configs.py:204-232 through the port: N = 72, M = 6,
    Q = 2, C = 3, whitened, the JAX package's initial state for
    PRNGKey(16), MAP + Adam at lr 0.05 for 50 steps. rtol 1e-5, atol
    1e-8, the golden's own."""
    golden = np.load(GOLDEN_LMC)["losses"]
    N, M = 72, 6
    rng = np.random.default_rng(31)
    X = np.sort(rng.random((N, 1)) * 5, axis=0)
    G = np.stack([np.sin(X[:, 0]), np.cos(1.3 * X[:, 0])], -1)
    W_true = np.array([[1.0, 0.5, -1.0], [0.2, -0.8, 0.4]])
    Y = G @ W_true + rng.standard_normal((N, C)) * 0.05
    Z0 = np.linspace(0.2, 4.8, M)[:, None]

    def golden_build(P):
        m = P.pkg.Model()
        m.n = P.pkg.Variable()
        m.X = P.pkg.Variable(shape=(m.n, 1))
        m.Y = P.modules.LMCSVGPRegression.define_variable(
            X=m.X, kernel=P.rbf(input_dim=1, variance=1.0, lengthscale=1.0,
                                dtype="float64"),
            num_outputs=C, num_latents=Q, shape=(m.n, C),
            inducing_inputs=P.pkg.Variable(shape=Z0.shape, initial_value=Z0),
            dtype="float64", whitened=True)
        return m

    with jax_f64():
        jm = golden_build(J)
        jinf = J.inf.GradBasedInference(
            J.inf.MAP(model=jm, observed=[jm.X, jm.Y]), dtype="float64")
        jinf.initialize(X=X, Y=Y, key=jax.random.PRNGKey(16))
    tm = golden_build(T)
    tinf = T.inf.GradBasedInference(
        T.inf.MAP(model=tm, observed=[tm.X, tm.Y]), dtype="float64",
        device="cpu")
    tinf.initialize(X=X, Y=Y)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    losses = []
    tinf.run(X=X, Y=Y, max_iter=50, learning_rate=0.05,
             callback=lambda i, l: losses.append(float(l)))
    np.testing.assert_allclose(losses, golden, rtol=1e-5, atol=1e-8)
