"""The slice as a whole: an SVGP trained by the JAX package, carried over
by name path and served by the port's BatchedPredictor, against the JAX
package's BatchedPredictor on the same rows."""
import numpy as np
import pytest
import torch

import mxfusion_tpu as mj
from mxfusion_tpu.common import config as jconfig
from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive
from mxfusion_tpu.components.distributions.gp.kernels import RBF as JRBF
from mxfusion_tpu.inference import (MAP, GradBasedInference,
                                    InferenceParameters as JParams,
                                    BatchedPredictor as JPredictor)
from mxfusion_tpu.modules import SVGPRegression as JSVGP
from mxfusion_tpu.modules.gp_modules.svgp_regression import \
    SVGPRegressionMeanVariancePrediction as JMeanVar
from mxfusion_tpu.ops import pallas_kernels as pk

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.inference import BatchedPredictor
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.modules.gp_modules.svgp_regression import \
    SVGPRegressionMeanVariancePrediction as MeanVar
from mxfusion_tpu_torch.util.carryover import carryover_params, name_paths

N, M, D = 512, 128, 4
N_TEST, CHUNK = 300, 128   # 2 full chunks and a padded tail of 44 rows
PATHS = {"noise_var", "inducing_inputs", "Y.qU_mean", "Y.qU_cov_W",
         "Y.qU_cov_diag", "Y.rbf_lengthscale", "Y.rbf_variance"}


def _model(pkg, Positive, Rbf, Svgp, Z0, whitened):
    m = pkg.Model()
    m.n = pkg.Variable()
    m.X = pkg.Variable(shape=(m.n, D))
    m.noise_var = pkg.Variable(transformation=Positive(), initial_value=0.1)
    m.Y = Svgp.define_variable(
        X=m.X, kernel=Rbf(input_dim=D, variance=1.0, lengthscale=1.0),
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=pkg.Variable(shape=(M, D), initial_value=Z0),
        whitened=whitened)
    return m


@pytest.fixture(scope="module", params=[False, True],
                ids=["standard", "whitened"])
def trained(request):
    """The JAX package trains by MAP for 20 steps in float64, as
    benchmarks/serving_throughput.py trains its served model."""
    rng = np.random.default_rng(0)
    X = rng.random((N, D)) * 4
    Y = np.sin(X[:, :1]) + rng.standard_normal((N, 1)) * 0.1
    Z0 = rng.random((M, D)) * 4
    old = jconfig.get_default_dtype()
    jconfig.set_default_dtype("float64")
    try:
        m = _model(mj, JPositive, JRBF, JSVGP, Z0, request.param)
        infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]))
        infr.run(max_iter=20, learning_rate=0.05, X=X, Y=Y)
    finally:
        jconfig.set_default_dtype(old)
    Xt = rng.random((N_TEST, D)) * 4
    return m, infr, Xt, Z0, request.param


def _port(trained, dtype):
    m, infr, _, Z0, whitened = trained
    tm = _model(mt, PositiveTransformation, RBF, SVGPRegression, Z0,
                whitened)
    state = {k: np.asarray(v) for k, v in infr.params.param_dict.items()}
    params = carryover_params(state, [tm], source_graphs=infr.graphs,
                              dtype=dtype, device="cpu")
    return tm, params


def _serve(pkg_predictor, model, params, Xt):
    pred = pkg_predictor(model=model, infr_params=params, observed=[model.X],
                         target_variables=[model.Y.uuid], chunk_size=CHUNK)
    mu, var = pred.predict(X=Xt)[0]
    return np.asarray(mu), np.asarray(var)


def test_carryover_matches_every_jax_parameter(trained):
    m, infr, _, _, _ = trained
    tm, params = _port(trained, "float64")
    jpaths = name_paths(infr.graphs)
    assert {jpaths[k] for k in infr.params.param_dict} == PATHS
    assert len(params.param_dict) == len(infr.params.param_dict) == len(PATHS)
    tpaths = name_paths([tm])
    for uuid, value in params.param_dict.items():
        juuid = next(k for k in infr.params.param_dict
                     if jpaths[k] == tpaths[uuid])
        np.testing.assert_array_equal(
            value.numpy(), np.asarray(infr.params.param_dict[juuid]))


def test_carryover_raises_on_unmatched_arrays(trained):
    tm, _ = _port(trained, "float64")
    with pytest.raises(KeyError, match="Y.qU_extra"):
        carryover_params({"Y.qU_extra": np.zeros(2)}, [tm])
    _, infr, _, _, _ = trained
    with pytest.raises(KeyError, match="no variables of the source"):
        carryover_params({"0123abcd": np.zeros(2)}, [tm],
                         source_graphs=infr.graphs)


def test_serving_matches_jax_f64(trained):
    m, infr, Xt, _, _ = trained
    tm, params = _port(trained, "float64")
    mu, var = _serve(BatchedPredictor, tm, params, Xt)
    muj, varj = _serve(JPredictor, m, infr.params, Xt)
    assert mu.shape == var.shape == (1, N_TEST, 1)
    assert mu.dtype == np.float64
    np.testing.assert_allclose(mu, muj, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(var, varj, rtol=1e-9, atol=1e-10)


def test_transfer_inference_run_matches_jax_f64(trained):
    """The unchunked path: TransferInference(ModulePredictionAlgorithm)
    .run, with the request as a tensor on the port's side."""
    from mxfusion_tpu.inference import (
        TransferInference as JTransfer, ModulePredictionAlgorithm as JAlg)
    from mxfusion_tpu_torch.inference import (
        TransferInference, ModulePredictionAlgorithm)
    m, infr, Xt, _, _ = trained
    tm, params = _port(trained, "float64")
    run = TransferInference(ModulePredictionAlgorithm(
        model=tm, observed=[tm.X], target_variables=[tm.Y.uuid]),
        infr_params=params)
    mu, var = run.run(X=torch.as_tensor(Xt[:50]))[0]
    jrun = JTransfer(JAlg(model=m, observed=[m.X],
                          target_variables=[m.Y.uuid]),
                     infr_params=infr.params)
    muj, varj = jrun.run(X=Xt[:50])[0]
    assert mu.shape == (1, 50, 1) and isinstance(mu, torch.Tensor)
    np.testing.assert_allclose(mu.numpy(), np.asarray(muj), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(var.numpy(), np.asarray(varj), rtol=1e-9,
                               atol=1e-10)


def test_serving_full_covariance_matches_jax_f64(trained):
    """The full-covariance, noisy branch: (s, C, C) leaves merged
    block-diagonally across chunks by both servers."""
    m, infr, Xt, _, whitened = trained
    tm, params = _port(trained, "float64")
    def attach(mod, alg):
        mod.attach_prediction_algorithms(
            targets=mod.output_names, conditionals=mod.input_names,
            algorithm=alg, alg_name="svgp_predict")

    default = m.Y.factor.svgp_predict
    for model, Alg in ((m, JMeanVar), (tm, MeanVar)):
        mod = model.Y.factor
        attach(mod, Alg(mod._module_graph, mod._extra_graphs[0],
                        [v for _, v in mod.inputs], noise_free=False,
                        diagonal_variance=False, jitter=mod.jitter,
                        whitened=whitened))
    try:
        mu, cov = _serve(BatchedPredictor, tm, params, Xt)
        muj, covj = _serve(JPredictor, m, infr.params, Xt)
    finally:
        attach(m.Y.factor, default)  # the JAX model is shared
    assert cov.shape == (1, N_TEST, N_TEST)
    assert cov[0, 0, CHUNK] == 0.0   # cross-chunk blocks are never computed
    np.testing.assert_allclose(mu, muj, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(cov, covj, rtol=1e-9, atol=1e-10)


def test_serving_matches_jax_pallas_interpret_f32(trained, monkeypatch):
    """float32 on both sides, the JAX package with its Pallas RBF kernel
    (interpret mode) on both grams of the prediction.

    Tolerance, relative to the largest output: 1e-4 for the standard
    parameterization. The whitened mean goes through L⁻ᵀ·qU_mean, and at
    this Kuu's conditioning float32 puts each package 1.5e-4 (port) and
    2.7e-4 (JAX) away from the float64 answer, so there the two agree
    to 5e-4 and the port stays within 5e-4 of float64."""
    m, infr, Xt, _, whitened = trained
    tol = 5e-4 if whitened else 1e-4
    tm64, params64 = _port(trained, "float64")
    ref = _serve(BatchedPredictor, tm64, params64, Xt)
    tm, params = _port(trained, "float32")
    jparams = JParams(dtype="float32")
    jparams.param_dict.update({k: np.asarray(v, np.float32)
                               for k, v in infr.params.param_dict.items()})
    calls = []
    real = pk._rbf_pallas_2d
    monkeypatch.setattr(pk, "_rbf_pallas_2d",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pk.set_use_pallas(True)
    pk.set_force_interpret(True)
    try:
        muj, varj = _serve(JPredictor, m, jparams, Xt.astype(np.float32))
    finally:
        pk.set_force_interpret(False)
        pk.set_use_pallas(False)
    assert len(calls) == 2          # Kuu and Kzx, traced once
    mu, var = _serve(BatchedPredictor, tm, params, Xt.astype(np.float32))
    assert mu.dtype == np.float32 and muj.dtype == np.float32
    for a, b, r in ((mu, muj, ref[0]), (var, varj, ref[1])):
        assert np.max(np.abs(a - b)) <= tol * np.max(np.abs(b))
        assert np.max(np.abs(a - r)) <= tol * np.max(np.abs(r))


def test_port_module_raises_for_training_paths(trained):
    tm, _ = _port(trained, "float64")
    with pytest.raises(NotImplementedError, match="training slice"):
        tm.Y.factor.log_pdf({}, targets=None)
    with pytest.raises(NotImplementedError, match="training slice"):
        tm.Y.factor.draw_samples({}, torch.Generator())


def test_serving_kernel_flag_off_gives_same_result_on_cpu(trained):
    """On the CPU both settings of the kernel flag run plain code; the
    flag only picks the route (wrapper or stationary path)."""
    from mxfusion_tpu_torch.ops import cuda_kernels
    _, _, Xt, _, _ = trained
    tm, params = _port(trained, "float32")
    on = _serve(BatchedPredictor, tm, params, Xt)
    cuda_kernels.set_use_kernel(False)
    try:
        off = _serve(BatchedPredictor, tm, params, Xt)
    finally:
        cuda_kernels.set_use_kernel(True)
    for a, b in zip(on, off):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
