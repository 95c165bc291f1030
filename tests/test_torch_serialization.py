"""``Inference.save``/``load`` of the port, within the port and across
packages, float64 on the CPU.

Both packages write the same zip (graph skeletons, parameter npz,
constants, configuration), and ``load`` matches the saved skeletons onto
freshly built graphs by reconciliation. So a zip saved by the JAX
package loads in the port and gives the JAX package's predictions, and
the reverse, at rtol 1e-10: SVGP regression, ``GPRegression`` (whose
prediction cache rides in the zip as fixed parameters), mean-field
posteriors (compared by the negative ELBO on shared fixed draws) and a
2-layer deep GP (whose unnamed layer variables pair positionally; shared
fixed draws). A JAX state carried in through the zip equals the same
state carried in through ``util.carryover``. The round trips of
``tests/inference/test_serialization.py`` (but the FlaxFunction BNN),
``test_module_replication.py::test_svgp_save_load_roundtrip`` and
``test_svgp_classification_integration.py::
test_classification_save_load_roundtrip`` run within the port.
"""
import json
import zipfile

import jax
import numpy as np
import pytest
import torch

from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive
from mxfusion_tpu.inference import create_executor as jcreate_executor

from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.common.exceptions import (InferenceError,
                                                  SerializationError)
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import create_executor
from mxfusion_tpu_torch.util import serialization
from mxfusion_tpu_torch.util.carryover import load_state, name_paths

from tests.test_torch_svgp_classification import (
    J, T, by_path, jax_f64, build as build_svgp, data as class_data)
from tests.test_torch_deep_gp import (
    build as build_deep_gp, data as deep_gp_data, draws_needed, moved)
from tests import test_torch_meanfield as mf

RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu_in_float64():
    """The port on the CPU, with float64 factors (the mean-field
    posteriors take the default dtype); the old defaults come back
    afterwards."""
    old = tconfig.set_default_device("cpu")
    old_dtype = tconfig.get_default_dtype()
    tconfig.set_default_dtype("float64")
    yield
    tconfig.set_default_dtype(old_dtype)
    tconfig.set_default_device(old)


def map_inference(P, m):
    kw = {} if P is J else {"device": "cpu"}
    return P.inf.GradBasedInference(
        P.inf.MAP(model=m, observed=[m.X, m.Y]), dtype="float64", **kw)


def serve(P, inf, Xt, chunk=16):
    m = inf.graphs[0]
    with jax_f64():
        out = P.inf.BatchedPredictor(
            model=m, infr_params=inf.params, observed=[m.X],
            target_variables=[m.Y.uuid], chunk_size=chunk).predict(X=Xt)[0]
    return [np.asarray(o) for o in out]


def set_by_path(P, inf, state):
    """Overwrite ``inf``'s store with ``state`` (by name path)."""
    if P is J:
        uuids = {p: u for u, p in name_paths(inf.graphs).items()}
        inf.params.update_params({uuids[p]: jax.numpy.asarray(v)
                                  for p, v in state.items()})
    else:
        load_state(inf.params, state, inf.graphs)


def shifted(inf, seed):
    """Every parameter of ``inf`` moved by seeded draws, by name path."""
    rng = np.random.default_rng(seed)
    return {p: v + 0.1 * rng.standard_normal(v.shape)
            for p, v in by_path(inf.graphs, inf.params.param_dict).items()}


# ---------------------------------------------------------------------
# the cases: ``build(P)`` a freshly built, initialized inference of
# package P, ``move(P, inf)`` a state off the initial one, ``outputs(P,
# inf)`` what the model predicts from it
# ---------------------------------------------------------------------

class SVGP:
    rng = np.random.default_rng(0)
    X = rng.random((40, 3)) * 4
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((40, 1))
    Z0 = rng.random((6, 3)) * 4
    Xt = rng.random((37, 3)) * 4

    def build(self, P):
        m = P.pkg.Model()
        m.n = P.pkg.Variable()
        m.X = P.pkg.Variable(shape=(m.n, 3))
        m.noise_var = P.pkg.Variable(
            transformation=JPositive() if P is J else
            PositiveTransformation(), initial_value=0.1)
        m.Y = P.modules.SVGPRegression.define_variable(
            X=m.X, kernel=P.rbf(input_dim=3, variance=1.3, lengthscale=0.9,
                                dtype="float64"),
            noise_var=m.noise_var, shape=(m.n, 1),
            inducing_inputs=P.pkg.Variable(shape=self.Z0.shape,
                                           initial_value=self.Z0),
            dtype="float64")
        inf = map_inference(P, m)
        with jax_f64():
            inf.initialize(X=self.X, Y=self.Y)
        return inf

    def move(self, P, inf):
        set_by_path(P, inf, shifted(inf, 1))

    def outputs(self, P, inf):
        return serve(P, inf, self.Xt)


class GP(SVGP):
    """``GPRegression``: two MAP steps write the prediction cache (fixed
    parameters) that the zip must carry."""

    def build(self, P):
        m = P.pkg.Model()
        m.N = P.pkg.Variable()
        m.X = P.pkg.Variable(shape=(m.N, 3))
        m.noise_var = P.pkg.Variable(
            transformation=JPositive() if P is J else
            PositiveTransformation(), initial_value=0.1)
        m.Y = P.modules.GPRegression.define_variable(
            X=m.X, kernel=P.rbf(input_dim=3, variance=1.3, lengthscale=0.9,
                                dtype="float64"),
            noise_var=m.noise_var, shape=(m.N, 1), dtype="float64")
        inf = map_inference(P, m)
        with jax_f64():
            inf.initialize(X=self.X, Y=self.Y)
        return inf

    def move(self, P, inf):
        with jax_f64():
            inf.run(max_iter=2, learning_rate=0.05, X=self.X, Y=self.Y)
        assert len(inf.params.fixed) == 3   # the (X, L, L⁻¹Y) cache


class DeepGP:
    """A 2-layer deep GP on fixed propagation draws (the default 20 a
    prediction takes, 16 rows in one chunk)."""
    X, Y, Z0s, rng = deep_gp_data(7, 20, [2, 2])
    Xt = rng.random((16, 2)) * 4
    noise = rng.standard_normal(draws_needed(20, 16, [2, 2]))

    def build(self, P):
        with jax_f64():
            m = build_deep_gp(P, "DeepGPRegression", self.Z0s,
                              fixed=self.noise, jitter=1e-6)
            inf = map_inference(P, m)
            inf.initialize(X=self.X, Y=self.Y)
        return inf

    def move(self, P, inf):
        set_by_path(P, inf, moved(by_path(inf.graphs, inf.params.param_dict),
                                  0, 2))

    def outputs(self, P, inf):
        return serve(P, inf, self.Xt, chunk=16)


class MeanField:
    """A mean-field posterior under SVI; the negative ELBO on S = 4
    fixed draws per latent stands for its prediction."""
    S = 4

    def __init__(self, model):
        self.model = model

    def build(self, P):
        Q = mf.J if P is J else mf.T
        with jax_f64():
            m, observed, self.data = self.model(Q)
            q = Q.meanfield(model=m, observed=observed)
            inf = P.inf.GradBasedInference(
                P.inf.StochasticVariationalInference(
                    num_samples=self.S, model=m, posterior=q,
                    observed=observed),
                dtype="float64", **({} if P is J else {"device": "cpu"}))
            inf.initialize(**self.data)
        return inf

    def move(self, P, inf):
        set_by_path(P, inf, shifted(inf, 2))

    def outputs(self, P, inf):
        alg = inf.inference_algorithm
        mf.fix_draws(alg.posterior, (mf.J if P is J else mf.T).Fixed,
                     self.S)
        data = [self.data[v.name] for v in alg.observed_variables]
        args = (inf.params.trainable_params(), inf.params.fixed_params(),
                data)
        if P is J:
            with jax_f64():
                loss = jcreate_executor(alg, inf.params)(
                    *args, jax.random.PRNGKey(0))[0]
            return [np.asarray(loss)]
        return [create_executor(alg, inf.params)(
            *args, torch.Generator())[0].detach().numpy()]


CASES = {"svgp": SVGP(), "gp": GP(),
         "meanfield": MeanField(mf.normal_with_gamma_variance),
         "meanfield_ppca": MeanField(mf.ppca), "deep_gp": DeepGP()}


def assert_same(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-14)


@pytest.fixture(scope="module", params=list(CASES))
def jax_zip(request, tmp_path_factory):
    """A JAX inference of each case, moved off its initial state and
    saved; its outputs."""
    case = CASES[request.param]
    jinf = case.build(J)
    case.move(J, jinf)
    path = str(tmp_path_factory.mktemp(request.param) / "jax.zip")
    with jax_f64():
        jinf.save(path)
    return case, jinf, path, case.outputs(J, jinf)


def test_jax_zip_loads_in_the_port(jax_zip):
    case, jinf, path, want = jax_zip
    tinf = case.build(T)
    tinf.load(path)
    assert len(tinf.params.fixed) == len(jinf.params.fixed)
    assert_same(case.outputs(T, tinf), want)


def test_jax_zip_equals_the_carryover(jax_zip):
    """Every parameter, loaded through the zip and reconciliation or
    carried by name path, holds the same bits."""
    case, jinf, path, _ = jax_zip
    loaded, carried = case.build(T), case.build(T)
    loaded.load(path)
    load_state(carried.params, {k: np.asarray(v) for k, v in
                                jinf.params.param_dict.items()},
               carried.graphs, source_graphs=jinf.graphs)
    a = by_path(loaded.graphs, loaded.params.param_dict)
    b = by_path(carried.graphs, carried.params.param_dict)
    assert set(a) == set(b) and len(a) == len(jinf.params.param_dict)
    for path_ in a:
        np.testing.assert_array_equal(a[path_], b[path_], err_msg=path_)


@pytest.mark.parametrize("name", list(CASES))
def test_port_zip_loads_in_jax(name, tmp_path):
    case = CASES[name]
    tinf = case.build(T)
    case.move(T, tinf)
    path = str(tmp_path / "port.zip")
    tinf.save(path)
    want = case.outputs(T, tinf)
    jinf = case.build(J)
    with jax_f64():
        jinf.load(path)
    assert jinf.params.fixed <= set(jinf.params.param_dict)
    assert len(jinf.params.fixed) == len(tinf.params.fixed)
    assert_same(case.outputs(J, jinf), want)


# ---------------------------------------------------------------------
# the zip itself
# ---------------------------------------------------------------------

def test_zip_layout_is_the_jax_packages(tmp_path):
    """The same six entries, version "1.0", nothing pickled, and a
    float32 store loading a float64 zip holds float32 on its device."""
    from mxfusion_tpu.util import serialization as jserialization
    assert serialization.FILENAMES == jserialization.FILENAMES
    assert serialization.SERIALIZATION_VERSION == \
        jserialization.SERIALIZATION_VERSION == "1.0"
    case = CASES["gp"]
    tinf = case.build(T)
    case.move(T, tinf)
    path = str(tmp_path / "gp.zip")
    tinf.save(path)
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == \
            sorted(serialization.FILENAMES.values())
        version = json.loads(zf.read("version.json"))
        config = json.loads(zf.read("configuration.json"))
        params = serialization.read_numpy_zip_bytes(
            zf.read("parameters.npz"))
    assert version["serialization_version"] == "1.0"
    assert config["observed_names"] == ["X", "Y"]
    assert sorted(config["fixed_uuids"]) == sorted(tinf.params.fixed)
    assert set(params) == set(tinf.params.param_dict)
    assert all(v.dtype == np.float64 for v in params.values())

    g = case.build(T).graphs[0]
    f32 = T.inf.GradBasedInference(T.inf.MAP(model=g, observed=[g.X, g.Y]),
                                   dtype="float32", device="cpu")
    f32.initialize(X=case.X, Y=case.Y)
    f32.load(path)
    for v in f32.params.param_dict.values():
        assert v.dtype == torch.float32 and v.device.type == "cpu"


def test_load_raises_on_version_and_unmatched_parameters(tmp_path):
    case = CASES["svgp"]
    tinf = case.build(T)
    path = str(tmp_path / "svgp.zip")
    tinf.save(path)
    with zipfile.ZipFile(path) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    bad = str(tmp_path / "bad.zip")
    with zipfile.ZipFile(bad, "w") as zf:
        for n, b in entries.items():
            if n == "version.json":
                b = json.dumps({"serialization_version": "0.9"})
            zf.writestr(n, b)
    with pytest.raises(SerializationError, match="version"):
        case.build(T).load(bad)
    # a saved parameter that matches no variable of the rebuilt graphs
    params = serialization.read_numpy_zip_bytes(entries["parameters.npz"])
    params["0" * 32] = np.zeros(2)
    with zipfile.ZipFile(bad, "w") as zf:
        for n, b in entries.items():
            if n == "parameters.npz":
                b = serialization.make_numpy_zip_bytes(params)
            zf.writestr(n, b)
    with pytest.raises(InferenceError, match="no reconciled match"):
        case.build(T).load(bad)


# ---------------------------------------------------------------------
# round trips within the port (tests/inference/test_serialization.py)
# ---------------------------------------------------------------------

def _meanfield(n=50):
    P = mf.T
    m = P.pkg.Model()
    m.mu = P.dist.Normal.define_variable(mean=0., variance=100., shape=(1,))
    m.s = P.pkg.Variable(transformation=P.Positive(), initial_value=5.)
    m.y = P.dist.Normal.define_variable(
        mean=P.ops.broadcast_to(m.mu, (n, 1)),
        variance=P.ops.broadcast_to(m.s, (n, 1)), shape=(n, 1))
    q = P.meanfield(model=m, observed=[m.y])
    alg = T.inf.StochasticVariationalInference(
        num_samples=5, model=m, posterior=q, observed=[m.y])
    return m, q, T.inf.GradBasedInference(alg, dtype="float64",
                                          device="cpu")


def test_meanfield_save_load_roundtrip(tmp_path):
    y = np.random.default_rng(0).standard_normal((50, 1)) + 2.0
    m1, q1, infr1 = _meanfield()
    infr1.run(max_iter=80, learning_rate=0.1, y=y)
    path = str(tmp_path / "inference.zip")
    infr1.save(path)
    m2, q2, infr2 = _meanfield()
    infr2.initialize(y=y)
    infr2.load(path)
    assert float(infr1.params[q1.mu.factor.mean]) == \
        float(infr2.params[q2.mu.factor.mean])
    assert float(infr1.params[m1.s]) == float(infr2.params[m2.s])
    assert abs(float(infr2.params[q2.mu.factor.mean])) > 0.1
    assert "s ({}): ".format(m2.s.uuid[:8]) in infr2.print_params()
    infr2.run(max_iter=10, learning_rate=0.05, y=y)


def test_gp_module_save_load_roundtrip(tmp_path):
    """Module-internal kernel parameters reconcile and load; the
    predictions of the loaded inference equal the saved one's."""
    case = CASES["gp"]
    infr1 = case.build(T)
    infr1.run(max_iter=100, learning_rate=0.05, X=case.X, Y=case.Y)
    path = str(tmp_path / "gp.zip")
    infr1.save(path)
    infr2 = case.build(T)
    infr2.load(path)
    k1 = infr1.graphs[0].Y.factor._module_graph.kernel
    k2 = infr2.graphs[0].Y.factor._module_graph.kernel
    np.testing.assert_array_equal(infr1.params[k1.lengthscale].numpy(),
                                  infr2.params[k2.lengthscale].numpy())
    assert_same(case.outputs(T, infr2), case.outputs(T, infr1))


def test_fixed_params_survive_save_load(tmp_path):
    """The GP's cache stays fixed after the round trip, and a resumed
    run keeps it out of the trainable set."""
    case = CASES["gp"]
    infr1 = case.build(T)
    infr1.run(max_iter=20, learning_rate=0.05, X=case.X, Y=case.Y)
    n_fixed = len(infr1.params.fixed)
    assert n_fixed > 0
    path = str(tmp_path / "gp_fixed.zip")
    infr1.save(path)
    infr2 = case.build(T)
    infr2.load(path)
    assert len(infr2.params.fixed) == n_fixed
    before = set(infr2.params.fixed)
    infr2.run(max_iter=5, learning_rate=0.01, X=case.X, Y=case.Y)
    assert before <= set(infr2.params.fixed)
    assert not (set(infr2.params.trainable_params()) & infr2.params.fixed)


def test_svgp_save_load_roundtrip(tmp_path):
    """The variational parameters inside the module's posterior graph
    reconcile over (``test_module_replication``)."""
    case = CASES["svgp"]
    infr1 = case.build(T)
    infr1.run(max_iter=60, learning_rate=0.05, X=case.X, Y=case.Y)
    path = str(tmp_path / "svgp.zip")
    infr1.save(path)
    infr2 = case.build(T)
    infr2.load(path)
    q1 = infr1.graphs[0].Y.factor._extra_graphs[0]
    q2 = infr2.graphs[0].Y.factor._extra_graphs[0]
    for name in ("qU_mean", "qU_cov_diag", "qU_cov_W"):
        np.testing.assert_array_equal(
            infr1.params[getattr(q1, name)].numpy(),
            infr2.params[getattr(q2, name)].numpy())
    assert_same(case.outputs(T, infr2), case.outputs(T, infr1))


def test_classification_save_load_roundtrip(tmp_path):
    X, Y, Z0 = class_data(2, 40, 6, D=1)
    Xt = np.linspace(0.05, 3.95, 15)[:, None]

    def fresh():
        m = build_svgp(T, "SVGPClassification", Z0)
        return map_inference(T, m)

    infr1 = fresh()
    infr1.run(X=X, Y=Y, max_iter=120, learning_rate=0.05)
    path = str(tmp_path / "svgpc.zip")
    infr1.save(path)
    infr2 = fresh()
    infr2.initialize(X=X, Y=Y)
    infr2.load(path)
    p1, p2 = serve(T, infr1, Xt), serve(T, infr2, Xt)
    assert_same(p2, p1)
    assert 0.0 < p2[0].min() and p2[0].max() < 1.0
