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
random numbers refuses to export. The test marked ``cuda`` exports on
the card, where K1 is an operator node of the program. This file imports
no JAX, so that it runs on the card as it is.
"""
import json
import zipfile

import numpy as np
import pytest
import torch

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.common import config as tconfig
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


def test_a_prediction_that_draws_refuses_to_export(tmp_path):
    """A deep GP's prediction draws its propagation samples from the
    caller's generator, which an exported program has no input for."""
    rng = np.random.default_rng(8)
    X = rng.random((20, 2)) * 4
    Y = np.sin(X[:, :1])
    m = mt.Model()
    m.n = mt.Variable()
    m.X = mt.Variable(shape=(m.n, 2))
    m.noise_var = mt.Variable(transformation=PositiveTransformation(),
                              initial_value=0.1)
    m.Y = DeepGPRegression.define_variable(
        X=m.X, kernels=[RBF(input_dim=2), RBF(input_dim=2)],
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=[mt.Variable(shape=(4, 2),
                                     initial_value=rng.random((4, 2)) * 4),
                         mt.Variable(shape=(4, 2),
                                     initial_value=rng.standard_normal(
                                         (4, 2)))])
    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                              dtype="float64", device="cpu")
    infr.initialize(X=X, Y=Y)
    with pytest.raises(NotImplementedError, match="draws random numbers"):
        predictor(m, infr, 8).export(str(tmp_path / "dgp.zip"), X=X[:8])


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
