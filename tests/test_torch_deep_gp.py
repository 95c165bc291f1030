"""``DeepGPRegression`` and ``DeepGPClassification`` against the JAX
package, float64 on the CPU.

A 1-layer stack has no propagation draw, so its bound equals the
single-layer module's (the JAX package's own oracle, held here inside the
port). Deeper stacks draw one (S, N, D_l) block of normals per inner
layer, in layer order, and the sampling prediction one more: both
packages get the same normals through their ``FixedRandomGenerator``, so
the bounds, their gradients in every parameter, both predictions and the
sampling prediction agree at rtol 1e-10, and so do forward draws of the
generative graph. Also: an explicit
``num_samples=1``, an env that already carries s = 3 samples, the
replicated module, a carried JAX state (layer-indexed name paths) and
the constructors' validation.
"""
import jax
import numpy as np
import pytest
import torch

from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive

from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.distributions import RandomGenerator
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.modules.gp_modules import deep_gp as tdgp
from mxfusion_tpu_torch.util.carryover import (carryover_params, load_state,
                                               name_paths)

from tests.test_torch_svgp_classification import (
    J, T, RTOL, assert_same_bound, by_path, jax_f64, serve)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


REG, CLS = "DeepGPRegression", "DeepGPClassification"
POSITIVE = {"jax": JPositive, "torch": PositiveTransformation}


def build(P, module, Z0s, fixed=None, variance=1.0, lengthscale=1.0,
          **kw):
    """``module`` over X with one RBF layer per inducing set in ``Z0s``
    (layer l's width is Z0s[l + 1]'s), a trainable noise variance for
    regression, and ``fixed`` as the module's random generator."""
    D = Z0s[0].shape[1]
    m = P.pkg.Model()
    m.n = P.pkg.Variable()
    m.X = P.pkg.Variable(shape=(m.n, D))
    if fixed is not None:
        kw["rand_gen"] = P.Fixed(fixed)
    if module == REG:
        m.noise_var = P.pkg.Variable(
            transformation=POSITIVE["jax" if P is J else "torch"](),
            initial_value=0.1)
        kw["noise_var"] = m.noise_var
    kernels = [P.rbf(input_dim=z.shape[1], variance=variance,
                     lengthscale=lengthscale, dtype="float64") for z in Z0s]
    m.Y = getattr(P.modules, module).define_variable(
        X=m.X, kernels=kernels, shape=(m.n, 1),
        inducing_inputs=[P.pkg.Variable(shape=z.shape, initial_value=z)
                         for z in Z0s], dtype="float64", **kw)
    return m


def moved(state, seed, layers):
    """Each layer's q(U) moved off its initial value by seeded draws."""
    rng = np.random.default_rng(seed)
    for l in range(layers):
        M, D = state["Y.qU_mean_%d" % l].shape
        state["Y.qU_mean_%d" % l] = rng.standard_normal((M, D)) * 0.5
        state["Y.qU_cov_W_%d" % l] = rng.standard_normal((M, M)) * 0.2 \
            + np.eye(M)
        state["Y.qU_cov_diag_%d" % l] = rng.uniform(-5.0, -3.0, M)
    return state


def pair(module, X, Y, Z0s, **kw):
    """The JAX MAP inference and the port's at one state: JAX's initial
    state with every layer's q(U) moved by seeded draws."""
    with jax_f64():
        jm = build(J, module, Z0s, **kw)
        jinf = J.inf.GradBasedInference(
            J.inf.MAP(model=jm, observed=[jm.X, jm.Y]), dtype="float64")
        jinf.initialize(X=X, Y=Y, key=jax.random.PRNGKey(0))
        state = moved(by_path(jinf.graphs, jinf.params.param_dict), 0,
                      len(Z0s))
        jpaths = {p: u for u, p in name_paths(jinf.graphs).items()}
        jinf.params.update_params(
            {jpaths[p]: jax.numpy.asarray(v) for p, v in state.items()})
    tm = build(T, module, Z0s, **kw)
    tinf = T.inf.GradBasedInference(
        T.inf.MAP(model=tm, observed=[tm.X, tm.Y]), dtype="float64",
        device="cpu")
    tinf.initialize(X=X, Y=Y)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    return jinf, tinf


def data(seed, N, widths, M=5, module=REG):
    """X (N, widths[0]) and Y, and one inducing set per layer: the first
    on the input box, the inner ones standard normal (latent space)."""
    rng = np.random.default_rng(seed)
    X = rng.random((N, widths[0])) * 4
    f = np.sin(X[:, :1]) + 0.3 * np.cos(2.0 * X[:, -1:])
    if module == REG:
        Y = f + 0.1 * rng.standard_normal((N, 1))
    else:
        Y = (rng.random((N, 1)) < 1.0 / (1.0 + np.exp(-3.0 * f))).astype(
            np.float64)
    Z0s = [rng.random((M, widths[0])) * 4] + [
        rng.standard_normal((M, w)) for w in widths[1:]]
    return X, Y, Z0s, rng


def draws_needed(S, N, widths):
    """Normals one bound draws: (S, N, D_l) per inner layer."""
    return S * N * sum(widths[1:])


# ---------------------------------------------------------------------
# the bounds
# ---------------------------------------------------------------------

@pytest.mark.parametrize("module", [REG, CLS])
@pytest.mark.parametrize("whitened", [True, False],
                         ids=["whitened", "standard"])
def test_one_layer_equals_the_single_layer_module(module, whitened):
    """A 1-layer stack's bound is ``SVGPRegression``'s (kernel variance 1,
    where the relative jitter is the absolute one) or
    ``SVGPClassification``'s, at the same state: the JAX package's
    oracle, here inside the port (1e-8 as there for regression, whose
    arithmetic differs; 1e-12 for classification, whose is shared)."""
    X, Y, Z0s, _ = data(1, 25, [2], M=6, module=module)
    _, tinf = pair(module, X, Y, Z0s, jitter=1e-8, whitened=whitened)
    single = "SVGPRegression" if module == REG else "SVGPClassification"
    m = T.pkg.Model()
    m.n = T.pkg.Variable()
    m.X = T.pkg.Variable(shape=(m.n, 2))
    kw = {}
    if module == REG:
        m.noise_var = T.pkg.Variable(
            transformation=PositiveTransformation(), initial_value=0.1)
        kw["noise_var"] = m.noise_var
    m.Y = getattr(T.modules, single).define_variable(
        X=m.X, kernel=T.rbf(input_dim=2, dtype="float64"), shape=(m.n, 1),
        inducing_inputs=T.pkg.Variable(shape=Z0s[0].shape,
                                       initial_value=Z0s[0]),
        dtype="float64", jitter=1e-8, whitened=whitened, **kw)
    sinf = T.inf.GradBasedInference(
        T.inf.MAP(model=m, observed=[m.X, m.Y]), dtype="float64",
        device="cpu")
    sinf.initialize(X=X, Y=Y)
    deep = by_path(tinf.graphs, tinf.params.param_dict)
    load_state(sinf.params, {
        p.replace("_0", "").replace("p(F).", ""): v for p, v in deep.items()},
        sinf.graphs)
    losses = []
    for inf in (tinf, sinf):
        ex = T.inf.create_executor(inf.inference_algorithm, inf.params)
        losses.append(float(ex(inf.params.trainable_params(),
                               inf.params.fixed_params(), [X, Y],
                               torch.Generator().manual_seed(0))[0]))
    np.testing.assert_allclose(losses[0], losses[1],
                               rtol=1e-8 if module == REG else 1e-12)


@pytest.mark.parametrize("module", [REG, CLS])
@pytest.mark.parametrize("widths", [[2, 2], [3, 2, 2]],
                         ids=["two_layers", "three_layers"])
def test_bound_and_gradients_match_jax_on_the_same_draws(widths, module):
    """S = 3 propagation draws a bound, whitened (the default) at two
    layers and standard at three: the loss and every gradient (6 per
    layer, and the noise variance) at rtol 1e-10."""
    N, S = 20, 3
    X, Y, Z0s, rng = data(2, N, widths, module=module)
    noise = rng.standard_normal(draws_needed(S, N, widths))
    jinf, tinf = pair(module, X, Y, Z0s, fixed=noise, num_samples=S,
                      whitened=len(widths) == 2, jitter=1e-6,
                      variance=1.4, lengthscale=1.3)
    assert_same_bound(jinf, tinf, [X, Y],
                      6 * len(widths) + (module == REG))


def test_probit_link_and_per_output_noise_match_jax():
    """The probit link of the classifier, and a regression stack with a
    two-column output (the last layer 2 wide) and a per-output noise
    variance, on the same draws."""
    N, S = 16, 2
    X, Y, Z0s, rng = data(3, N, [2, 2], module=CLS)
    noise = rng.standard_normal(draws_needed(S, N, [2, 2]))
    jinf, tinf = pair(CLS, X, Y, Z0s, fixed=noise, num_samples=S,
                      link="probit", jitter=1e-6)
    assert_same_bound(jinf, tinf, [X, Y], 12)

    X, _, Z0s, rng = data(4, N, [2, 3])
    Y2 = np.stack([np.sin(X[:, 0]), np.cos(X[:, 1])], -1)
    noise = rng.standard_normal(draws_needed(S, N, [2, 3]))
    jinf, tinf = _two_columns(Z0s, noise, S, X, Y2)
    assert_same_bound(jinf, tinf, [X, Y2], 13)


def _two_columns(Z0s, noise, S, X, Y2):
    """A 2-layer regression stack of two output columns (widths 3 and 2)
    with a per-output noise variance, in both packages at JAX's initial
    state."""
    def make(P):
        pos = POSITIVE["jax" if P is J else "torch"]
        m = P.pkg.Model()
        m.n = P.pkg.Variable()
        m.X = P.pkg.Variable(shape=(m.n, 2))
        m.noise_var = P.pkg.Variable(shape=(2,), transformation=pos(),
                                     initial_value=np.array([0.1, 0.3]))
        m.Y = P.modules.DeepGPRegression.define_variable(
            X=m.X, kernels=[P.rbf(input_dim=2, dtype="float64"),
                            P.rbf(input_dim=3, dtype="float64")],
            noise_var=m.noise_var, shape=(m.n, 2),
            inducing_inputs=[P.pkg.Variable(shape=z.shape, initial_value=z)
                             for z in Z0s],
            rand_gen=P.Fixed(noise), num_samples=S, dtype="float64",
            jitter=1e-6)
        return m

    with jax_f64():
        jm = make(J)
        jinf = J.inf.GradBasedInference(
            J.inf.MAP(model=jm, observed=[jm.X, jm.Y]), dtype="float64")
        jinf.initialize(X=X, Y=Y2, key=jax.random.PRNGKey(1))
    tm = make(T)
    tinf = T.inf.GradBasedInference(
        T.inf.MAP(model=tm, observed=[tm.X, tm.Y]), dtype="float64",
        device="cpu")
    tinf.initialize(X=X, Y=Y2)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    return jinf, tinf


def test_sampled_hyperparameter_env_pins_the_draw_count():
    """An env whose noise variance carries s = 3 samples (an outer SVI
    pass) against a stack with num_samples = 5: the bound has one term
    per env sample, (3,), on 3 propagation draws, as JAX's."""
    N = 12
    X, Y, Z0s, rng = data(5, N, [2, 2])
    noise = rng.standard_normal(draws_needed(3, N, [2, 2]))
    jinf, tinf = pair(REG, X, Y, Z0s, fixed=noise, num_samples=5,
                      jitter=1e-6)
    out = []
    for P, inf in ((J, jinf), (T, tinf)):
        ex = P.inf.create_executor(inf.inference_algorithm, inf.params)
        with jax_f64():
            env = ex.build_env(inf.params.trainable_params(),
                               inf.params.fixed_params(), [X, Y])
            nv = inf.graphs[0].noise_var.uuid
            scale = np.array([[1.0], [2.0], [3.0]])
            env[nv] = env[nv] * (jax.numpy.asarray(scale) if P is J
                                 else torch.as_tensor(scale))
            ctx = P.inf.RuntimeContext(
                jax.random.PRNGKey(0) if P is J
                else torch.Generator().manual_seed(0))
            out.append(np.asarray(inf.graphs[0].Y.factor.log_pdf(env,
                                                                 ctx=ctx)))
    assert out[1].shape == (3,)
    np.testing.assert_allclose(out[1], out[0], rtol=RTOL)


def test_svi_over_a_sampled_noise_variance_trains():
    """The JAX package's test of the same name in spirit: a Gamma prior
    on the noise variance, a mean-field q over it, SVI with S = 3 draws
    against a stack whose num_samples is 5; three steps, finite losses."""
    from mxfusion_tpu_torch.components.distributions import Gamma
    X, Y, Z0s, _ = data(6, 10, [2, 2], M=4)
    m = T.pkg.Model()
    m.n = T.pkg.Variable()
    m.X = T.pkg.Variable(shape=(m.n, 2))
    m.noise_var = Gamma.define_variable(alpha=2.0, beta=10.0, shape=(1,))
    m.Y = T.modules.DeepGPRegression.define_variable(
        X=m.X, kernels=[T.rbf(input_dim=2), T.rbf(input_dim=2)],
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=[T.pkg.Variable(shape=z.shape, initial_value=z)
                         for z in Z0s], jitter=1e-6, num_samples=5)
    q = T.inf.create_Gaussian_meanfield(model=m, observed=[m.X, m.Y])
    inf = T.inf.GradBasedInference(T.inf.StochasticVariationalInference(
        num_samples=3, model=m, posterior=q, observed=[m.X, m.Y]),
        device="cpu")
    losses = []
    inf.run(max_iter=3, learning_rate=0.01, X=X, Y=Y,
            generator=torch.Generator().manual_seed(0),
            callback=lambda i, l: losses.append(float(l)))
    assert len(losses) == 3 and np.all(np.isfinite(losses))


# ---------------------------------------------------------------------
# predictions
# ---------------------------------------------------------------------

@pytest.mark.parametrize("module,noise_free,widths", [
    (REG, True, [2, 2]), (REG, False, [2, 2]), (CLS, True, [2, 2]),
    (REG, True, [2, 3, 2])],
    ids=["mean_variance", "mean_variance_noisy", "class_probability",
         "three_layers"])
def test_predictions_match_jax_on_the_same_draws(module, noise_free,
                                                 widths):
    """64 rows in one chunk, the default 20 propagation draws (the
    caller asked for none): the mixture's mean and variance, or the
    class probability and p(1−p), rtol 1e-10."""
    X, Y, Z0s, rng = data(7, 20, widths, module=module)
    Xt = rng.random((64, 2)) * 4
    noise = rng.standard_normal(draws_needed(20, 64, widths))
    jinf, tinf = pair(module, X, Y, Z0s, fixed=noise, jitter=1e-6)
    if not noise_free:
        for inf in (jinf, tinf):
            inf.graphs[0].Y.factor.deep_gp_predict.noise_free = False
    jout, tout = serve(jinf, tinf, Xt)
    for j, t in zip(jout, tout):
        assert t.shape == (1, 64, 1)
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-14)
    if module == CLS:
        assert 0.0 < tout[0].min() and tout[0].max() < 1.0


def _sampling_prediction(P, inf, num_samples, Xt):
    gp = inf.graphs[0].Y.factor
    gp.attach_prediction_algorithms(
        targets=gp.output_names, conditionals=gp.input_names,
        algorithm=P.modules.gp_modules.deep_gp.DeepGPSamplingPrediction(
            gp._module_graph, gp._extra_graphs[0],
            [v for _, v in gp.inputs], num_layers=gp.num_layers,
            whitened=gp.whitened, jitter=gp.jitter, noise_free=False,
            rand_gen=gp._rand_gen),
        alg_name="deep_gp_sample_pred")
    m = inf.graphs[0]
    kw = {"dtype": "float64"}
    if P is T:
        kw["device"] = "cpu"
    pred = P.inf.TransferInference(P.inf.ModulePredictionAlgorithm(
        model=m, observed=[m.X], target_variables=[m.Y.uuid],
        num_samples=num_samples), infr_params=inf.params, **kw)
    if P is J:
        with jax_f64():
            return np.asarray(pred.run(X=Xt, key=jax.random.PRNGKey(0))[0])
    return pred.run(X=Xt, generator=torch.Generator().manual_seed(0))[
        0].numpy()


def test_sampling_prediction_matches_jax_on_the_same_draws():
    """``DeepGPSamplingPrediction`` with the observation noise: 9 draws
    of 7 rows through ``ModulePredictionAlgorithm``, the inner layer's
    normals first and the final draw's after them."""
    X, Y, Z0s, rng = data(8, 18, [2, 2])
    Xt = X[:7]
    noise = rng.standard_normal(9 * 7 * 3)
    jinf, tinf = pair(REG, X, Y, Z0s, fixed=noise, jitter=1e-6)
    js = _sampling_prediction(J, jinf, 9, Xt)
    ts = _sampling_prediction(T, tinf, 9, Xt)
    assert ts.shape == (9, 7, 1)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("module", [REG, CLS])
def test_forward_draws_match_jax(module):
    """Forward sampling of the generative graph U_0 → F_0 (with the
    skip mean dot(X, W_0)) → U_1 → F_1 → Y, on the same fixed normals
    (the Bernoulli labels take the buffer's numbers as they are)."""
    X, _, Z0s, rng = data(12, 9, [2, 2], M=4, module=module)
    draws = 3
    noise = rng.standard_normal(4000)
    with jax_f64():
        jm = build(J, module, Z0s, fixed=noise, jitter=1e-6)
        jinf = J.inf.Inference(J.inf.ForwardSamplingAlgorithm(
            model=jm, observed=[jm.X], num_samples=draws,
            target_variables=[jm.Y.uuid]), dtype="float64")
        jinf.initialize(X=X, key=jax.random.PRNGKey(0))
        (jy,) = jinf.run(X=X, key=jax.random.PRNGKey(0))
    tm = build(T, module, Z0s, fixed=noise, jitter=1e-6)
    tinf = T.inf.Inference(T.inf.ForwardSamplingAlgorithm(
        model=tm, observed=[tm.X], num_samples=draws,
        target_variables=[tm.Y.uuid]), dtype="float64", device="cpu")
    tinf.initialize(X=X)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    (ty,) = tinf.run(X=X, generator=torch.Generator().manual_seed(0))
    assert ty.shape == (draws, 9, 1)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=1e-12)


class _Recording(RandomGenerator):
    """The default generator, recording the shape of each normal draw."""

    def __init__(self):
        self.shapes = []

    def sample_normal(self, generator, loc=0.0, scale=1.0, shape=None,
                      dtype=None):
        self.shapes.append(tuple(shape))
        return super().sample_normal(generator, loc, scale, shape, dtype)


def test_explicit_num_samples_one_is_honoured():
    """``predict(num_samples=1)`` propagates one draw; no request
    propagates ``default_samples`` (20); 7 propagates 7."""
    X, Y, Z0s, _ = data(9, 12, [2, 2], M=4)
    rec = _Recording()
    m = build(T, REG, Z0s, jitter=1e-8, num_samples=2)
    m.Y.factor._rand_gen = rec
    for alg in (m.Y.factor.deep_gp_predict, m.Y.factor.deep_gp_log_pdf):
        alg._rand_gen = rec
    inf = T.inf.GradBasedInference(T.inf.MAP(model=m, observed=[m.X, m.Y]),
                                   dtype="float64", device="cpu")
    inf.initialize(X=X, Y=Y)

    def run(num_samples):
        rec.shapes.clear()
        kw = {} if num_samples is None else {"num_samples": num_samples}
        T.inf.TransferInference(T.inf.ModulePredictionAlgorithm(
            model=m, observed=[m.X], target_variables=[m.Y.uuid], **kw),
            infr_params=inf.params, device="cpu").run(
                X=X[:5], generator=torch.Generator().manual_seed(0))
        return [s[0] for s in rec.shapes]

    assert run(1) == [1]
    assert run(None) == [20]
    assert run(7) == [7]


# ---------------------------------------------------------------------
# replication, carryover, validation
# ---------------------------------------------------------------------

def test_replicated_stack_gives_the_same_bound():
    """``model.clone()`` of a 2-layer classifier: the clone, given the
    original's state and the same draws, has JAX's bound."""
    N, S = 16, 2
    X, Y, Z0s, rng = data(10, N, [2, 2], M=4, module=CLS)
    noise = rng.standard_normal(draws_needed(S, N, [2, 2]))
    jinf, tinf = pair(CLS, X, Y, Z0s, fixed=noise, num_samples=S,
                      jitter=1e-6)
    clone = tinf.graphs[0].clone()
    rep = clone.Y.factor
    assert (rep.num_layers, rep.link, rep.num_samples) == (2, "logit", S)
    rep._rand_gen.reset()
    cinf = T.inf.GradBasedInference(
        T.inf.MAP(model=clone, observed=[clone.X, clone.Y]),
        dtype="float64", device="cpu")
    cinf.initialize(X=X, Y=Y)
    load_state(cinf.params, by_path(tinf.graphs, tinf.params.param_dict),
               cinf.graphs)
    assert_same_bound(jinf, cinf, [X, Y], 12)


def test_carried_state_gives_the_same_bound():
    """A JAX state trained by 5 MAP steps on fixed draws, carried into a
    fresh port model by name path: the layer-indexed paths, the two
    kernels' parameters told apart by their layer, and the same bound."""
    N, S = 14, 2
    X, Y, Z0s, rng = data(11, N, [2, 2], M=4)
    noise = rng.standard_normal(draws_needed(S, N, [2, 2]))
    with jax_f64():
        jm = build(J, REG, Z0s, fixed=noise, num_samples=S, jitter=1e-6)
        jinf = J.inf.GradBasedInference(
            J.inf.MAP(model=jm, observed=[jm.X, jm.Y]), dtype="float64")
        jinf.run(X=X, Y=Y, max_iter=5, learning_rate=0.05,
                 key=jax.random.PRNGKey(4))
    jm.Y.factor._rand_gen.reset()
    state = by_path(jinf.graphs, jinf.params.param_dict)
    assert set(state) == {"noise_var"} | {
        p % l for l in (0, 1) for p in (
            "inducing_inputs_%d", "Y.qU_mean_%d", "Y.qU_cov_W_%d",
            "Y.qU_cov_diag_%d", "Y.p(F_%d).rbf_lengthscale",
            "Y.p(F_%d).rbf_variance")}
    tm = build(T, REG, Z0s, fixed=noise, num_samples=S, jitter=1e-6)
    params = carryover_params(state, [tm], dtype="float64", device="cpu")
    tinf = T.inf.GradBasedInference(
        T.inf.MAP(model=tm, observed=[tm.X, tm.Y]), dtype="float64",
        device="cpu")
    tinf.initialize(X=X, Y=Y)
    tinf.params.update_params(params.param_dict)
    assert_same_bound(jinf, tinf, [X, Y], 13)


@pytest.mark.parametrize("P", [J, T], ids=["jax", "torch"])
def test_constructor_validation(P):
    """Both packages refuse the same constructions: no kernels, an
    unknown inner mean, a wrong count of inducing sets, an unknown link,
    a classifier whose output is not one column."""
    X = np.zeros((3, 2))
    rbf = P.rbf
    with pytest.raises(ValueError):
        P.modules.DeepGPRegression(X=X, kernels=[], noise_var=0.1)
    with pytest.raises(ValueError):
        P.modules.DeepGPRegression(X=X, kernels=[rbf(input_dim=2)],
                                   noise_var=0.1, inner_mean="bogus")
    with pytest.raises(ValueError):
        P.modules.DeepGPRegression(
            X=X, kernels=[rbf(input_dim=2), rbf(input_dim=1)],
            noise_var=0.1, inducing_inputs=[P.pkg.Variable(shape=(4, 2))])
    with pytest.raises(ValueError):
        P.modules.DeepGPClassification(X=X, kernels=[rbf(input_dim=2)],
                                       link="bogus")
    with pytest.raises(ValueError):
        P.modules.DeepGPClassification.define_variable(
            X=P.pkg.Variable(shape=(3, 2)), kernels=[rbf(input_dim=2)],
            shape=(3, 2))


def test_identity_mean_weights():
    """The skip map is the identity, truncated or zero-padded."""
    np.testing.assert_array_equal(tdgp._identity_mean_weights(3, 2),
                                  np.eye(3)[:, :2])
    np.testing.assert_array_equal(tdgp._identity_mean_weights(2, 3),
                                  np.eye(2, 3))
