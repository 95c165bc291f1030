"""``BatchedPredictor.export`` and ``load_exported_predictor``.

The port's counterparts of the export tests of
``tests/inference/test_serving.py`` (the round trip, export before the
first request, LMC's full output covariance with the recorded input
dtypes, the derived output spec staying soft), and what is the port's
own: an exported SVGP predictor equals the live one to 1e-12 on the CPU,
whatever float32 matmul precision the serving process has set; the
program records each product as ``mxfusion_tpu_torch::tiered_einsum``
with its tier and no plain matmul; K1's operator has a fake
implementation and no CPU kernel; the loader refuses a JAX artifact and
an artifact traced on another device type; a prediction that draws
exports with its base draws as program inputs and equals the live
predictor on the same generator state; a network's buffers are program
inputs; a torch-1.0 artifact still serves; a gamma draw and a Dropout in
training mode refuse to export. The test marked ``cuda`` exports on
the card, where K1 is an operator node of the program. This file imports
no JAX, so that it runs on the card as it is.
"""
import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.distributions.random_gen import \
    RandomGenerator
from mxfusion_tpu_torch.components.functions import NNFunction
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    BatchedPredictor, ExportedPredictor, GradBasedInference, MAP,
    load_exported_predictor)
from mxfusion_tpu_torch.inference.serving import _DerivedSpec
from mxfusion_tpu_torch.modules import (DeepGPRegression, GPRegression,
                                        LMCSVGPRegression, SVGPRegression)
from mxfusion_tpu_torch.modules.gp_modules.gp_regression import \
    GPRegressionMeanVariancePrediction
from mxfusion_tpu_torch.modules.gp_modules.lmc_svgp import \
    LMCSVGPMeanVariancePrediction
from mxfusion_tpu_torch.ops import cuda_kernels


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


def trained_gp(rng, N=40, dtype="float64"):
    X = rng.random((N, 1)) * 4
    Y = np.sin(X) + rng.standard_normal((N, 1)) * 0.1
    m = mt.Model()
    m.N = mt.Variable()
    m.X = mt.Variable(shape=(m.N, 1))
    m.noise_var = mt.Variable(transformation=PositiveTransformation(),
                              initial_value=0.1)
    m.Y = GPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=1, variance=1.0, lengthscale=1.0),
        noise_var=m.noise_var, shape=(m.N, 1))
    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                              dtype=dtype, device="cpu")
    infr.run(max_iter=60, learning_rate=0.05, X=X, Y=Y)
    return m, infr


def trained_svgp(rng, N=60, D=2, M=8, dtype="float64", device="cpu"):
    X = rng.random((N, D)) * 4
    Y = np.sin(X[:, :1]) + rng.standard_normal((N, 1)) * 0.1
    m = mt.Model()
    m.n = mt.Variable()
    m.X = mt.Variable(shape=(m.n, D))
    m.noise_var = mt.Variable(transformation=PositiveTransformation(),
                              initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D, variance=1.0, lengthscale=1.0),
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=mt.Variable(shape=(M, D),
                                    initial_value=rng.random((M, D)) * 4))
    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                              dtype=dtype, device=device)
    infr.run(max_iter=40, learning_rate=0.05, X=X, Y=Y)
    return m, infr


def predictor(m, infr, chunk):
    return BatchedPredictor(model=m, infr_params=infr.params,
                            observed=[m.X], target_variables=[m.Y.uuid],
                            chunk_size=chunk)


def test_export_and_load_predictor_roundtrip(tmp_path):
    """The artifact serves without the model graph: 37 rows through
    chunk 16 (a padded tail) equal the live predictor's."""
    rng = np.random.default_rng(3)
    m, infr = trained_gp(rng)
    Xt = np.linspace(0, 4, 37)[:, None]
    pred = predictor(m, infr, 16)
    mu_live, var_live = pred.predict(X=Xt)[0]
    path = str(tmp_path / "predictor.zip")
    assert pred.export(path) == path
    served = load_exported_predictor(path, device="cpu")
    assert isinstance(served, ExportedPredictor)
    mu, var = served.predict(X=Xt)[0]
    assert mu.shape == mu_live.shape == (1, 37, 1)
    np.testing.assert_allclose(mu, mu_live, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(var, var_live, rtol=1e-12, atol=1e-14)
    # a later request of another length reuses the same program
    mu5, _ = served.predict(X=Xt[:5])[0]
    np.testing.assert_allclose(mu5, mu_live[:, :5], rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("precision", ["highest", "medium"])
def test_exported_svgp_equals_the_live_predictor(tmp_path, precision):
    """float64 SVGP, 3 chunks of 32 and a tail: the artifact served by a
    process that set the float32 matmul precision equals the live
    predictor to 1e-12."""
    rng = np.random.default_rng(5)
    m, infr = trained_svgp(rng)
    Xt = rng.random((101, 2)) * 4
    pred = predictor(m, infr, 32)
    live = pred.predict(X=Xt)[0]
    path = str(tmp_path / "svgp.zip")
    pred.export(path)
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        served = load_exported_predictor(path, device="cpu").predict(X=Xt)[0]
    finally:
        torch.set_float32_matmul_precision(old)
    for a, b in zip(served, live):
        assert a.shape == b.shape == (1, 101, 1)
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)


PLAIN_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                  torch.ops.aten.matmul.default, torch.ops.aten.einsum.default,
                  torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def test_program_records_each_product_with_its_tier(tmp_path):
    """Every product of the exported SVGP program is a tiered_einsum
    node that carries its tier; none is a plain matmul, so none runs at
    the serving process's precision."""
    rng = np.random.default_rng(6)
    m, infr = trained_svgp(rng, dtype="float32")
    pred = predictor(m, infr, 16)
    path = str(tmp_path / "svgp32.zip")
    pred.export(path, X=rng.random((16, 2)).astype(np.float32))
    program = load_exported_predictor(path, device="cpu")._program
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    op = torch.ops.mxfusion_tpu_torch.tiered_einsum.default
    tiered = [n.args[3] for n in program.graph.nodes
              if n.op == "call_function" and n.target == op]
    assert tiered and set(tiered) <= {"highest", "high", "default"}
    assert not PLAIN_PRODUCTS & set(targets)


@pytest.mark.parametrize("in_dims", [(0, None), (None, 2), (1, 0)])
def test_tiered_operator_under_vmap_and_hessian(in_dims):
    """The operator's vmap rule (a fresh leading index per batched
    operand) and a hessian through the tiered product equal plain
    einsum's, float64."""
    from mxfusion_tpu_torch.ops import precision
    g = torch.Generator().manual_seed(0)
    shapes = {(0, None): ((3, 4, 5), (5, 2)), (None, 2): ((4, 5), (5, 2, 3)),
              (1, 0): ((4, 3, 5), (3, 5, 2))}[in_dims]
    A, B = (torch.randn(s, generator=g, dtype=torch.float64)
            for s in shapes)
    got = torch.func.vmap(lambda a, b: precision.einsum("ij,jk->ik", a, b),
                          in_dims=in_dims)(A, B)
    want = torch.func.vmap(lambda a, b: torch.einsum("ij,jk->ik", a, b),
                           in_dims=in_dims)(A, B)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)
    X = torch.randn((3, 4, 5), generator=g, dtype=torch.float64)
    W = torch.randn((5, 2), generator=g, dtype=torch.float64)
    h = torch.func.hessian(
        lambda x: precision.einsum("...ij,jk->...ik", x, W).sin().sum())(X)
    h0 = torch.func.hessian(
        lambda x: torch.einsum("...ij,jk->...ik", x, W).sin().sum())(X)
    torch.testing.assert_close(h, h0, rtol=1e-12, atol=1e-14)


def test_export_before_predict_needs_example(tmp_path):
    rng = np.random.default_rng(4)
    m, infr = trained_gp(rng)
    pred = predictor(m, infr, 8)
    path = str(tmp_path / "p.zip")
    with pytest.raises(ValueError, match="example"):
        pred.export(path)
    Xt = np.linspace(0, 4, 20)[:, None]
    pred.export(path, X=Xt)
    mu, _ = load_exported_predictor(path, device="cpu").predict(X=Xt)[0]
    assert mu.shape == (1, 20, 1)
    np.testing.assert_allclose(mu, pred.predict(X=Xt)[0][0], rtol=1e-12)


def test_lmc_full_output_cov_serving_and_export(tmp_path):
    """LMC's per-point cross-output covariance (s, N, C, C) round-trips
    through export; the artifact records its float32 input dtype and
    casts a float64 request to it."""
    rng = np.random.default_rng(3)
    N, C, Q = 50, 3, 2
    X = np.sort(rng.random((N, 1)) * 6, 0)
    G = np.stack([np.sin(X[:, 0]), np.cos(1.3 * X[:, 0])], -1)
    Y = G @ np.array([[1.0, 0.5, -1.0], [0.2, -0.8, 0.4]]) \
        + rng.standard_normal((N, C)) * 0.05
    m = mt.Model()
    m.n = mt.Variable()
    m.X = mt.Variable(shape=(m.n, 1))
    m.Y = LMCSVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=1), num_outputs=C, num_latents=Q,
        shape=(m.n, C), inducing_inputs=mt.Variable(
            shape=(8, 1), initial_value=np.linspace(0.1, 5.9, 8)[:, None]))
    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                              dtype="float32", device="cpu")
    infr.run(X=X.astype(np.float32), Y=Y.astype(np.float32), max_iter=40,
             learning_rate=0.05)
    lmc = m.Y.factor
    lmc.attach_prediction_algorithms(
        targets=lmc.output_names, conditionals=lmc.input_names,
        algorithm=LMCSVGPMeanVariancePrediction(
            lmc._module_graph, lmc._extra_graphs[0],
            [v for _, v in lmc.inputs], noise_free=False,
            full_output_cov=True),
        alg_name="lmc_svgp_predict")
    Xt = np.linspace(0.0, 6.0, 37)[:, None]
    pred = predictor(m, infr, 16)
    mu_live, cov_live = pred.predict(X=Xt.astype(np.float32))[0]
    assert cov_live.shape == (1, 37, C, C)
    path = str(tmp_path / "lmc.zip")
    pred.export(path)
    with zipfile.ZipFile(path) as zf:
        assert json.loads(zf.read("meta.json"))["input_dtypes"] == \
            ["float32"]
    mu, cov = load_exported_predictor(path, device="cpu").predict(X=Xt)[0]
    assert mu.dtype == cov.dtype == np.float32
    np.testing.assert_allclose(mu, mu_live, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(cov, cov_live, rtol=1e-6, atol=1e-7)


def test_exported_derived_spec_stays_soft(tmp_path):
    """An output spec derived from ``serving_data_axes`` keeps its soft,
    per-leaf-validated semantics through export and load."""
    rng = np.random.default_rng(13)
    m, infr = trained_gp(rng)
    gp = m.Y.factor
    gp.attach_prediction_algorithms(
        targets=gp.output_names, conditionals=gp.input_names,
        algorithm=GPRegressionMeanVariancePrediction(
            gp._module_graph, gp._extra_graphs[0],
            [v for _, v in gp.inputs], noise_free=False,
            diagonal_variance=False),
        alg_name="gp_predict")
    pred = predictor(m, infr, 16)
    Xt = np.linspace(0, 4, 20)[:, None]
    mu_live, cov_live = pred.predict(X=Xt)[0]
    assert isinstance(pred.output_spec, _DerivedSpec)
    path = str(tmp_path / "gp_cov.zip")
    pred.export(path)
    served = load_exported_predictor(path, device="cpu")
    assert isinstance(served._output_spec, _DerivedSpec)
    mu, cov = served.predict(X=Xt)[0]
    assert cov.shape == (1, 20, 20)
    np.testing.assert_allclose(mu, mu_live, rtol=1e-12)
    np.testing.assert_allclose(cov, cov_live, rtol=1e-12, atol=1e-14)


def _rewritten(path, out, edit):
    with zipfile.ZipFile(path) as zf:
        items = {n: zf.read(n) for n in zf.namelist()}
    edit(items)
    with zipfile.ZipFile(out, "w") as zf:
        for n, b in items.items():
            zf.writestr(n, b)
    return out


def test_loader_refuses_jax_and_other_device_artifacts(tmp_path):
    rng = np.random.default_rng(7)
    m, infr = trained_gp(rng, N=20)
    path = str(tmp_path / "gp.zip")
    predictor(m, infr, 8).export(path, X=np.linspace(0, 4, 8)[:, None])

    def as_jax(items):
        items["function.bin"] = b"\x00"
        del items["program.pt2"]

    def on_cuda(items):
        meta = json.loads(items["meta.json"])
        meta["device"] = "cuda"
        items["meta.json"] = json.dumps(meta)

    def old_format(items):
        meta = json.loads(items["meta.json"])
        meta["format_version"] = "1.2"
        items["meta.json"] = json.dumps(meta)

    with pytest.raises(ValueError, match="JAX package"):
        load_exported_predictor(_rewritten(path, str(tmp_path / "j.zip"),
                                           as_jax), device="cpu")
    with pytest.raises(ValueError, match="traced on cuda"):
        load_exported_predictor(_rewritten(path, str(tmp_path / "c.zip"),
                                           on_cuda), device="cpu")
    with pytest.raises(ValueError, match="version"):
        load_exported_predictor(_rewritten(path, str(tmp_path / "v.zip"),
                                           old_format), device="cpu")


def trained_deep_gp(rng, rand_gen=None):
    """A 2-layer deep GP regression (RBF(2) → 2 → RBF(2) → 1, M = 4)
    after 5 MAP steps, float64; its predictions draw S = 20 propagation
    samples from the caller's generator."""
    X = rng.random((20, 2)) * 4
    Y = np.sin(X[:, :1])
    m = mt.Model()
    m.n = mt.Variable()
    m.X = mt.Variable(shape=(m.n, 2))
    m.noise_var = mt.Variable(transformation=PositiveTransformation(),
                              initial_value=0.1)
    m.Y = DeepGPRegression.define_variable(
        X=m.X, kernels=[RBF(input_dim=2), RBF(input_dim=2)],
        noise_var=m.noise_var, shape=(m.n, 1), rand_gen=rand_gen,
        inducing_inputs=[mt.Variable(shape=(4, 2),
                                     initial_value=rng.random((4, 2)) * 4),
                         mt.Variable(shape=(4, 2),
                                     initial_value=rng.standard_normal(
                                         (4, 2)))])
    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                              dtype="float64", device="cpu")
    infr.run(max_iter=5, learning_rate=0.05, X=X, Y=Y,
             generator=torch.Generator().manual_seed(0))
    return m, infr, X


def test_a_drawing_artifact_equals_the_live_predictor_on_each_seed(tmp_path):
    """The deep GP's propagation draws are program inputs, drawn at each
    chunk from the caller's generator: on two seeds (19 rows, chunks of
    8) the artifact equals the live predictor to the bit, the two seeds'
    outputs differ (no draw is baked into the program), and the default
    generator is the live predictor's."""
    rng = np.random.default_rng(8)
    m, infr, X = trained_deep_gp(rng)
    pred = predictor(m, infr, 8)
    path = str(tmp_path / "dgp.zip")
    pred.export(path, X=X[:8])
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
    assert meta["format_version"] == "torch-1.1"
    assert meta["draws"] == [{"kind": "normal", "shape": [20, 8, 2],
                              "dtype": "float64"}]
    served = load_exported_predictor(path, device="cpu")
    Xt = rng.random((19, 2)) * 4
    outs = []
    for seed in (1, 2):
        g_live = torch.Generator().manual_seed(seed)
        g_served = torch.Generator().manual_seed(seed)
        live = pred.predict(X=Xt, generator=g_live)[0]
        out = served.predict(X=Xt, generator=g_served)[0]
        for a, b in zip(out, live):
            assert a.shape == (1, 19, 1)
            np.testing.assert_array_equal(a, b)
        # the stream advanced as far on both sides
        assert torch.equal(g_live.get_state(), g_served.get_state())
        outs.append(out)
    assert np.abs(outs[0][0] - outs[1][0]).min() > 0
    for a, b in zip(served.predict(X=Xt)[0], pred.predict(X=Xt)[0]):
        np.testing.assert_array_equal(a, b)


def test_a_torch_1_0_artifact_still_loads_and_serves():
    """``tests/goldens/export_torch_1_0_svgp.zip``, written in format
    torch-1.0 by ``tests/oracles/torch_export_v1_0.py``, serves the live
    predictor's answer that was stored beside it."""
    golden = os.path.join(os.path.dirname(__file__), "goldens",
                          "export_torch_1_0_svgp")
    with zipfile.ZipFile(golden + ".zip") as zf:
        assert json.loads(zf.read("meta.json"))["format_version"] == \
            "torch-1.0"
    want = np.load(golden + ".npz")
    served = load_exported_predictor(golden + ".zip", device="cpu")
    mu, var = served.predict(X=want["X"])[0]
    np.testing.assert_allclose(mu, want["mean"], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(var, want["variance"], rtol=1e-12,
                               atol=1e-14)


class _StudentTPropagation(RandomGenerator):
    """Heavy-tailed propagation: each normal draw is a Student-t draw,
    whose chi-square is a gamma draw."""

    def sample_normal(self, generator, loc=0.0, scale=1.0, shape=None,
                      dtype=None):
        n = super().sample_normal(generator, shape=shape, dtype=dtype)
        g = self.sample_gamma(generator, alpha=2.5, shape=shape,
                              dtype=dtype)
        return loc + scale * n * torch.sqrt(2.5 / g)


def test_a_gamma_draw_refuses_to_export(tmp_path):
    """A gamma draw has no parameter-free base draw to make an input of:
    export names it; the live predictor serves."""
    rng = np.random.default_rng(9)
    m, infr, X = trained_deep_gp(rng, rand_gen=_StudentTPropagation())
    pred = predictor(m, infr, 8)
    mu, _ = pred.predict(X=X)[0]
    assert np.isfinite(mu).all()
    with pytest.raises(NotImplementedError, match="gamma draw"):
        pred.export(str(tmp_path / "t.zip"))


class _NormedNet(torch.nn.Module):
    """Linear → BatchNorm1d → tanh → Linear, with a dropout between."""

    def __init__(self, p=0.0):
        super().__init__()
        self.inp = torch.nn.Linear(2, 5)
        self.bn = torch.nn.BatchNorm1d(5)
        self.drop = torch.nn.Dropout(p)
        self.out = torch.nn.Linear(5, 2)

    def forward(self, x):
        return self.out(self.drop(torch.tanh(self.bn(self.inp(x)))))


class _DropNet(torch.nn.Module):
    """Dropout, then a (2, 2) kernel: applied once over the sample axis
    (``broadcastable``), the weights carrying it too."""

    def __init__(self):
        super().__init__()
        self.drop = torch.nn.Dropout(0.2)
        self.kernel = torch.nn.Parameter(torch.eye(2))

    def forward(self, x):
        return torch.tanh(self.drop(x) @ self.kernel)


def network_svgp(rng, *nets, names=("feat",), N=40, broadcastable=False):
    """Networks (``_NormedNet``, eval-mode statistics set from seeded
    draws), applied in turn under ``names``, in front of an SVGP
    regression, 20 MAP steps, float64."""
    torch.manual_seed(0)
    X = rng.standard_normal((N, 2))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    m = mt.Model()
    m.n = mt.Variable()
    m.X_raw = mt.Variable(shape=(m.n, 2))
    x = m.X_raw
    for net, name in zip(nets, names):
        if hasattr(net, "bn"):
            with torch.no_grad():
                net.bn.running_mean.copy_(
                    torch.as_tensor(rng.standard_normal(5)))
                net.bn.running_var.copy_(
                    torch.as_tensor(rng.random(5) + 0.5))
        x = NNFunction(net, name=name, input_shapes=[(N, 2)],
                       broadcastable=broadcastable, dtype="float64",
                       device="cpu")(x)
    m.X = x
    m.noise_var = mt.Variable(transformation=PositiveTransformation(),
                              initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=2), noise_var=m.noise_var,
        shape=(m.n, 1), inducing_inputs=mt.Variable(
            shape=(6, 2), initial_value=rng.standard_normal((6, 2))))
    infr = GradBasedInference(MAP(model=m, observed=[m.X_raw, m.Y]),
                              dtype="float64", device="cpu")
    infr.run(max_iter=20, learning_rate=0.05, X_raw=X, Y=Y)
    pred = BatchedPredictor(model=m, infr_params=infr.params,
                            observed=[m.X_raw], target_variables=[m.Y.uuid],
                            chunk_size=16)
    return pred, X


def test_network_buffers_are_program_inputs(tmp_path):
    """A BatchNorm's running statistics (eval mode) travel in params.npz
    under their names and enter the program as inputs, not constants:
    the artifact equals the live predictor to the bit, and a statistic
    edited in params.npz moves the served answer."""
    rng = np.random.default_rng(12)
    net = _NormedNet().double().eval()
    pred, X = network_svgp(rng, net)
    Xt = rng.standard_normal((37, 2))
    live = pred.predict(X_raw=Xt)[0]
    path = str(tmp_path / "bn.zip")
    pred.export(path)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        arrays = np.load(io.BytesIO(zf.read("params.npz")))
        np.testing.assert_array_equal(arrays["b::feat_bn_running_mean"],
                                      net.bn.running_mean.numpy())
    assert meta["buffers"] == ["feat_bn_running_mean", "feat_bn_running_var",
                               "feat_bn_num_batches_tracked"]
    assert meta["draws"] == [] and meta["matmul_precision"] == "highest"
    served = load_exported_predictor(path, device="cpu")
    assert not served._program.constants
    for a, b in zip(served.predict(X_raw=Xt)[0], live):
        np.testing.assert_array_equal(a, b)

    def shifted(items):
        z = dict(np.load(io.BytesIO(items["params.npz"])))
        z["b::feat_bn_running_mean"] = z["b::feat_bn_running_mean"] + 1.0
        buf = io.BytesIO()
        np.savez(buf, **z)
        items["params.npz"] = buf.getvalue()

    moved = load_exported_predictor(
        _rewritten(path, str(tmp_path / "moved.zip"), shifted),
        device="cpu").predict(X_raw=Xt)[0]
    assert np.abs(moved[0] - live[0]).max() > 1e-3


def test_two_networks_whose_buffers_share_a_name(tmp_path):
    """Two BatchNorm networks wrapped under one name would share the
    artifact's buffer names: export refuses them and names the fix;
    under two names each keeps its own statistics, and the artifact
    equals the live predictor to the bit."""
    rng = np.random.default_rng(14)
    nets = [_NormedNet().double().eval() for _ in range(2)]
    pred, _ = network_svgp(rng, *nets, names=("feat", "feat"))
    Xt = rng.standard_normal((21, 2))
    pred.predict(X_raw=Xt)
    with pytest.raises(ValueError, match="different names"):
        pred.export(str(tmp_path / "same.zip"))
    rng = np.random.default_rng(14)
    pred, _ = network_svgp(rng, *nets, names=("feat", "head"))
    live = pred.predict(X_raw=Xt)[0]
    path = pred.export(str(tmp_path / "two.zip"))
    with zipfile.ZipFile(path) as zf:
        arrays = np.load(io.BytesIO(zf.read("params.npz")))
        for name, net in zip(("feat", "head"), nets):
            np.testing.assert_array_equal(
                arrays["b::{}_bn_running_var".format(name)],
                net.bn.running_var.numpy())
    assert not np.array_equal(nets[0].bn.running_var.numpy(),
                              nets[1].bn.running_var.numpy())
    served = load_exported_predictor(path, device="cpu")
    for a, b in zip(served.predict(X_raw=Xt)[0], live):
        np.testing.assert_array_equal(a, b)


def test_export_while_another_thread_serves(tmp_path):
    """Export records and replays draws in its own thread: a drawing
    predictor serving in a second thread meanwhile draws from its own
    generator, as it does alone, and the artifact lists the draws of the
    one exported with no other thread about."""
    import threading
    rng = np.random.default_rng(15)
    m, infr, X = trained_deep_gp(rng)
    pred = predictor(m, infr, 8)
    Xt = rng.random((19, 2)) * 4
    want = pred.predict(X=Xt, generator=torch.Generator().manual_seed(3))[0]
    quiet = pred.export(str(tmp_path / "quiet.zip"))
    got, errors, stop = [], [], threading.Event()

    def serve():
        try:
            while not stop.is_set():
                got.append(pred.predict(
                    X=Xt, generator=torch.Generator().manual_seed(3))[0])
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    server = threading.Thread(target=serve)
    server.start()
    try:
        while not got and not errors:
            server.join(0.01)
        before = len(got)
        busy = pred.export(str(tmp_path / "busy.zip"))
        during = len(got) - before
    finally:
        stop.set()
        server.join()
    assert not errors, errors
    assert during > 0, "the second thread served nothing during export"
    for out in got:
        for a, b in zip(out, want):
            np.testing.assert_array_equal(a, b)

    def draws(path):
        with zipfile.ZipFile(path) as zf:
            return json.loads(zf.read("meta.json"))["draws"]

    assert draws(busy) == draws(quiet)
    served = load_exported_predictor(busy, device="cpu").predict(
        X=Xt, generator=torch.Generator().manual_seed(3))[0]
    for a, b in zip(served, want):
        np.testing.assert_array_equal(a, b)


def test_dropout_in_training_mode_refuses_to_export(tmp_path):
    """A network whose forward draws (Dropout in training mode, applied
    once over the sample axis) draws from torch's global generator, not
    from an input: export refuses it and names eval mode; the same
    network in eval mode exports."""
    rng = np.random.default_rng(13)
    net = _DropNet().double().eval()
    pred, X = network_svgp(rng, net, broadcastable=True)
    net.drop.train()
    with pytest.raises(NotImplementedError, match="eval mode"):
        pred.export(str(tmp_path / "drop.zip"), X_raw=X[:16])
    net.drop.eval()
    pred.export(str(tmp_path / "drop.zip"), X_raw=X[:16])


def serve_in_subprocess(path, **inputs):
    """Serve the artifact at ``path`` in a fresh process that imports
    only this package and numpy (no model, no network class, no JAX) on
    the CPU; returns the flattened outputs as numpy arrays."""
    work = os.path.dirname(path)
    np.savez(os.path.join(work, "request.npz"), **inputs)
    script = SERVE_SCRIPT.format(path=path, work=work)
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", script], check=True, env=env,
                   cwd=work, timeout=300)
    out = np.load(os.path.join(work, "served.npz"))
    return [out["leaf_%d" % i] for i in range(len(out.files))]


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_SCRIPT = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from mxfusion_tpu_torch.inference import load_exported_predictor
from torch.utils import _pytree as pytree
request = dict(np.load("{work}/request.npz"))
served = load_exported_predictor("{path}", device="cpu")
leaves = pytree.tree_leaves(served.predict(**request))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "tests",
                                                     "mxfusion_tpu")]
assert not bad, bad
np.savez("{work}/served.npz",
         **{{"leaf_%d" % i: x for i, x in enumerate(leaves)}})
"""


def test_k1_operator_has_a_fake_shape_and_no_cpu_kernel():
    """The fake implementation gives (s, N, M) float32 for
    ``torch.export``; a CPU tensor finds no kernel (the CPU branch of
    ``rbf_kernel_matrix`` is the plain version, never the operator)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    op = torch.ops.mxfusion_tpu_torch.rbf_gram
    f32 = {"dtype": torch.float32}   # not the default dtype a test may set
    ls, var = torch.ones((2, 1), **f32), torch.ones((2, 1), **f32)
    with FakeTensorMode():
        K = op(torch.empty((2, 5, 3), **f32), torch.empty((2, 7, 3), **f32),
               torch.ones((2, 1), **f32), torch.ones((2, 1), **f32))
        assert K.shape == (2, 5, 7) and K.dtype == torch.float32
        assert op(torch.empty((2, 5, 3), **f32), None,
                  torch.ones((2, 1), **f32),
                  torch.ones((2, 1), **f32)).shape == (2, 5, 5)
    with pytest.raises(NotImplementedError):
        op(torch.zeros((2, 5, 3), **f32), None, ls, var)
    X = torch.rand((2, 5, 3), **f32)
    before = cuda_kernels.rbf_kernel_matrix.launches
    K = cuda_kernels.rbf_kernel_matrix(X, None, ls, var)
    assert cuda_kernels.rbf_kernel_matrix.launches == before
    torch.testing.assert_close(K, cuda_kernels._rbf_torch(X, None, ls, var))


@pytest.mark.cuda
def test_cuda_export_records_k1_and_serves_as_the_live_predictor(tmp_path):
    """On the card the program holds K1 as its operator (Kuu and Kzx: two
    nodes), counted when the artifact runs, and serves the live
    predictor's answer in a process set to "medium"."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(9)
    m, infr = trained_svgp(rng, N=256, D=4, M=32, dtype="float32",
                           device="cuda")
    Xt = (rng.random((300, 4)) * 4).astype(np.float32)
    pred = predictor(m, infr, 128)
    live = pred.predict(X=Xt)[0]
    path = str(tmp_path / "svgp_cuda.zip")
    pred.export(path)
    served = load_exported_predictor(path, device="cuda")
    targets = [n.target for n in served._program.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.mxfusion_tpu_torch.rbf_gram.default) == 2
    assert torch.ops.mxfusion_tpu_torch.tiered_einsum.default in targets
    assert not PLAIN_PRODUCTS & set(targets)
    before = cuda_kernels.rbf_kernel_matrix.launches
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        out = served.predict(X=Xt)[0]
    finally:
        torch.set_float32_matmul_precision(old)
    assert cuda_kernels.rbf_kernel_matrix.launches == before + 2 * 3
    np.testing.assert_allclose(out[0], live[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out[1], live[1], rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="traced on cuda"):
        load_exported_predictor(path, device="cpu")
