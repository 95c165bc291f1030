"""``SVGPMultiClassification`` against the JAX package: the Monte Carlo
bound and its gradients on the same (s, N, C, K) normals, injected
through each package's ``FixedRandomGenerator``; the predicted class
probabilities (which sum to 1), forward draws and a carried JAX state.
float64, rtol 1e-10."""
import jax
import numpy as np
import pytest
import torch

from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.util.carryover import carryover_params, load_state

from tests.test_torch_svgp_classification import (
    J, T, RTOL, assert_same_bound, build, by_path, jax_f64, pair, serve)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


MC = "SVGPMultiClassification"
C, K = 3, 4


def one_hot(seed, N, M, D=2):
    """Labels by the equal-count bins of a latent f, one-hot."""
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 4
    f = np.sin(2.0 * X[:, 0]) + 0.3 * X[:, 1]
    y = np.searchsorted(np.quantile(f, np.linspace(0, 1, C + 1)[1:-1]), f)
    Z0 = rng.random((M, D)) * 4
    return X, np.eye(C)[y], Z0, rng


@pytest.mark.parametrize("whitened", [False, True],
                         ids=["standard", "whitened"])
@pytest.mark.parametrize("width", ["narrow", "wide"])
def test_bound_and_gradients_match_jax_on_the_same_draws(width, whitened):
    M = 8
    N = 20 if width == "narrow" else 64
    X, Y, Z0, rng = one_hot(1, N, M)
    noise = rng.standard_normal(N * C * K)
    jinf, tinf = pair(MC, X, Y, Z0, columns=C, num_classes=C,
                      num_mc_samples=K, noise=noise, whitened=whitened,
                      jitter=1e-4)
    assert_same_bound(jinf, tinf, [X, Y], 6)


def test_bound_draws_on_the_callers_generator():
    """Without a fixed generator the draws come from the generator the
    executor is given: the same seed gives the same bound, another seed
    another one."""
    X, Y, Z0, _ = one_hot(2, 24, 6)
    _, tinf = pair(MC, X, Y, Z0, columns=C, num_classes=C)
    ex = T.inf.create_executor(tinf.inference_algorithm, tinf.params)
    losses = [float(ex(tinf.params.trainable_params(),
                       tinf.params.fixed_params(), [X, Y],
                       torch.Generator().manual_seed(s))[0])
              for s in (3, 3, 4)]
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("whitened", [False, True],
                         ids=["standard", "whitened"])
def test_predictions_match_jax_and_sum_to_one(whitened):
    """64 rows, one chunk; the prediction draws (1, 64, C, 64) normals
    from the same buffer in both packages."""
    X, Y, Z0, rng = one_hot(3, 40, 7)
    Xt = rng.random((64, 2)) * 4
    noise = rng.standard_normal(64 * C * 64)
    jinf, tinf = pair(MC, X, Y, Z0, columns=C, num_classes=C,
                      noise=noise, whitened=whitened)
    jout, tout = serve(jinf, tinf, Xt)
    for j, t in zip(jout, tout):
        assert t.shape == (1, 64, C)
        np.testing.assert_allclose(t, j, rtol=RTOL)
    np.testing.assert_allclose(tout[0].sum(-1), 1.0, rtol=1e-12)


def test_forward_draws_match_jax():
    """U → F (C columns) → Categorical(softmax F), one-hot, by forward
    sampling under the same fixed draws: normals for U and F, then class
    indices for Y."""
    X, _, Z0, rng = one_hot(4, 9, 5)
    draws = 3
    noise = np.concatenate([rng.standard_normal(draws * (5 + 9) * C),
                            rng.integers(0, C, draws * 9)])
    with jax_f64():
        jm = build(J, MC, Z0, columns=C, num_classes=C, noise=noise)
        jinf = J.inf.Inference(J.inf.ForwardSamplingAlgorithm(
            model=jm, observed=[jm.X], num_samples=draws,
            target_variables=[jm.Y.uuid]), dtype="float64")
        jinf.initialize(X=X, key=jax.random.PRNGKey(0))
        (jy,) = jinf.run(X=X, key=jax.random.PRNGKey(0))
    tm = build(T, MC, Z0, columns=C, num_classes=C, noise=noise)
    tinf = T.inf.Inference(T.inf.ForwardSamplingAlgorithm(
        model=tm, observed=[tm.X], num_samples=draws,
        target_variables=[tm.Y.uuid]), dtype="float64", device="cpu")
    tinf.initialize(X=X)
    load_state(tinf.params, {k: np.asarray(v) for k, v in
                             jinf.params.param_dict.items()},
               tinf.graphs, source_graphs=jinf.graphs)
    (ty,) = tinf.run(X=X, generator=torch.Generator().manual_seed(0))
    assert ty.shape == (draws, 9, C)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-9,
                               atol=1e-12)


def test_carried_state_gives_the_same_bound():
    """A JAX state trained by 10 MAP steps on fixed draws, carried by
    name path into a fresh port model: the same bound on those draws."""
    X, Y, Z0, rng = one_hot(5, 30, 6)
    noise = rng.standard_normal(30 * C * 8)
    with jax_f64():
        jm = build(J, MC, Z0, columns=C, num_classes=C, noise=noise)
        jinf = J.inf.GradBasedInference(
            J.inf.MAP(model=jm, observed=[jm.X, jm.Y]), dtype="float64")
        jinf.run(X=X, Y=Y, max_iter=10, learning_rate=0.05,
                 key=jax.random.PRNGKey(3))
    jm.Y.factor._rand_gen.reset()
    state = by_path(jinf.graphs, jinf.params.param_dict)
    assert set(state) == {"inducing_inputs", "Y.qU_mean", "Y.qU_cov_W",
                          "Y.qU_cov_diag", "Y.rbf_lengthscale",
                          "Y.rbf_variance"}
    assert state["Y.qU_mean"].shape == (6, C)
    tm = build(T, MC, Z0, columns=C, num_classes=C, noise=noise)
    params = carryover_params(state, [tm], dtype="float64", device="cpu")
    tinf = T.inf.GradBasedInference(
        T.inf.MAP(model=tm, observed=[tm.X, tm.Y]), dtype="float64",
        device="cpu")
    tinf.initialize(X=X, Y=Y)
    tinf.params.update_params(params.param_dict)
    assert_same_bound(jinf, tinf, [X, Y], 6)
