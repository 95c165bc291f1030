"""The multivariate-normal family against the JAX package and scipy.

The MVN cases of ``tests/components/distributions/test_multivariate.py``
(log-pdfs, the sample/no-sample sweeps, the precision gradient) run
through both packages on the same numpy inputs, float64, rtol 1e-10
against JAX; draws are held to JAX under the same noise, fed through
the ``FixedRandomGenerator`` doubles of both packages. Also the
univariate ``NormalMeanPrecision``, the ``dot`` operator and the
broadcasting of the HIGHEST einsum that the MVN draw relies on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from mxfusion_tpu.components import distributions as jdist
from mxfusion_tpu.components.distributions.random_gen import \
    FixedRandomGenerator as JFixed
from mxfusion_tpu.components.variables.variable import Variable as JVariable
from mxfusion_tpu.util.testutils import make_spd_matrix

from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components import distributions as tdist
from mxfusion_tpu_torch.components.distributions.random_gen import \
    FixedRandomGenerator
from mxfusion_tpu_torch.components.variables.variable import Variable
from mxfusion_tpu_torch.ops import precision


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port runs on the card unless the CPU is asked for: these tests
    ask for it, and put the previous default back afterwards."""
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


RTOL = 1e-10


def _runtime(value, has_samples, to):
    a = np.asarray(value, dtype=np.float64)
    return to(a if has_samples else a[None])


def _build(dist_mod, Var, to, cls, param_values, rv_value, rv_has_samples,
           rand_gen=None):
    inputs = {name: Var() for name in param_values}
    dist = getattr(dist_mod, cls)(dtype="float64", rand_gen=rand_gen,
                                  **inputs)
    dist._generate_outputs(shape=np.asarray(rv_value).shape[
        1 if rv_has_samples else 0:])
    env = {inputs[name].uuid: _runtime(value, has_samples, to)
           for name, (value, has_samples) in param_values.items()}
    if rv_value is not None:
        env[dist.random_variable.uuid] = _runtime(rv_value, rv_has_samples,
                                                  to)
    return dist, env


def both_log_pdf(cls, param_values, rv, rv_has_samples):
    """log_pdf of the same inputs in both packages: (port, JAX)."""
    out = []
    for dist_mod, Var, to in ((tdist, Variable, torch.as_tensor),
                              (jdist, JVariable, jnp.asarray)):
        dist, env = _build(dist_mod, Var, to, cls, param_values, rv,
                           rv_has_samples)
        out.append(np.asarray(dist.log_pdf(env)))
    return out


def test_multivariate_normal_log_pdf():
    rng = np.random.default_rng(0)
    D, B, S = 3, 4, 5
    mean = rng.standard_normal((B, D))
    cov = np.stack([make_spd_matrix(D, rng) for _ in range(B)])
    rv = rng.standard_normal((S, B, D))
    result, jresult = both_log_pdf(
        "MultivariateNormal", {"mean": (mean, False),
                               "covariance": (cov, False)}, rv, True)
    expected = np.stack([
        [stats.multivariate_normal.logpdf(rv[s, b], mean[b], cov[b])
         for b in range(B)] for s in range(S)])
    assert result.shape == (S, B)
    np.testing.assert_allclose(result, jresult, rtol=RTOL)
    np.testing.assert_allclose(result, expected, rtol=1e-7, atol=1e-10)


def test_multivariate_normal_mean_precision_log_pdf():
    rng = np.random.default_rng(2)
    D, B, S = 3, 4, 5
    mean = rng.standard_normal((B, D))
    prec = np.stack([make_spd_matrix(D, rng) for _ in range(B)])
    rv = rng.standard_normal((S, B, D))
    result, jresult = both_log_pdf(
        "MultivariateNormalMeanPrecision",
        {"mean": (mean, False), "precision": (prec, False)}, rv, True)
    expected = np.stack([
        [stats.multivariate_normal.logpdf(rv[s, b], mean[b],
                                          np.linalg.inv(prec[b]))
         for b in range(B)] for s in range(S)])
    np.testing.assert_allclose(result, jresult, rtol=RTOL)
    np.testing.assert_allclose(result, expected, rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("mean_s,cov_s,rv_s", [
    (True, True, True), (False, True, True), (True, False, True),
    (False, False, True), (True, True, False), (False, False, False)])
def test_multivariate_normal_log_pdf_sweep(mean_s, cov_s, rv_s):
    rng = np.random.default_rng(10)
    D, B, S = 3, 2, 4
    mean = rng.standard_normal(((S, B, D) if mean_s else (B, D)))
    cov_b = np.stack([make_spd_matrix(D, rng) for _ in range(B)])
    cov = (np.stack([cov_b + 0.1 * s * np.eye(D) for s in range(S)])
           if cov_s else cov_b)
    rv = rng.standard_normal(((S, B, D) if rv_s else (B, D)))
    result, jresult = both_log_pdf(
        "MultivariateNormal", {"mean": (mean, mean_s),
                               "covariance": (cov, cov_s)}, rv, rv_s)
    n_out = S if (mean_s or cov_s or rv_s) else 1
    assert result.shape == jresult.shape == (n_out, B)
    np.testing.assert_allclose(result, jresult, rtol=RTOL)


@pytest.mark.parametrize("mean_s,prec_s,rv_s", [
    (True, True, True), (False, False, True), (True, False, False)])
def test_mvn_mean_precision_log_pdf_sweep(mean_s, prec_s, rv_s):
    rng = np.random.default_rng(11)
    D, B, S = 3, 2, 4
    mean = rng.standard_normal(((S, B, D) if mean_s else (B, D)))
    prec_b = np.stack([make_spd_matrix(D, rng) for _ in range(B)])
    prec = (np.stack([prec_b + 0.1 * s * np.eye(D) for s in range(S)])
            if prec_s else prec_b)
    rv = rng.standard_normal(((S, B, D) if rv_s else (B, D)))
    result, jresult = both_log_pdf(
        "MultivariateNormalMeanPrecision",
        {"mean": (mean, mean_s), "precision": (prec, prec_s)}, rv, rv_s)
    assert result.shape == jresult.shape
    np.testing.assert_allclose(result, jresult, rtol=RTOL)


@pytest.mark.parametrize("cls,param", [
    ("MultivariateNormal", "covariance"),
    ("MultivariateNormalMeanPrecision", "precision")])
@pytest.mark.parametrize("param_s", [False, True])
def test_mvn_draws_match_jax_under_shared_noise(cls, param, param_s):
    """Draws of both parameterizations, with and without a sample axis
    on the parameters, fed the same noise: rtol 1e-10."""
    rng = np.random.default_rng(12)
    D, B, S = 4, 3, 5
    mean = rng.standard_normal((S, B, D) if param_s else (B, D))
    mats = np.stack([make_spd_matrix(D, rng) for _ in range(B)])
    if param_s:
        mats = np.stack([mats + 0.2 * s * np.eye(D) for s in range(S)])
    noise = rng.standard_normal(S * B * D)
    out = []
    for dist_mod, Var, to, Fixed, gen in (
            (tdist, Variable, torch.as_tensor, FixedRandomGenerator,
             torch.Generator()),
            (jdist, JVariable, jnp.asarray, JFixed, jax.random.PRNGKey(0))):
        dist, env = _build(dist_mod, Var, to, cls,
                           {"mean": (mean, param_s),
                            param: (mats, param_s)},
                           np.zeros((B, D)), False, rand_gen=Fixed(noise))
        del env[dist.random_variable.uuid]
        out.append(np.asarray(dist.draw_samples(env, gen, num_samples=S)))
    assert out[0].shape == (S, B, D)
    np.testing.assert_allclose(out[0], out[1], rtol=RTOL, atol=1e-12)


def test_multivariate_normal_sampling_moments():
    """The port's own generator: 40000 draws have the covariance's
    moments (the JAX test's tolerances)."""
    rng = np.random.default_rng(1)
    D = 3
    mean = rng.standard_normal((1, D))
    cov = make_spd_matrix(D, rng)[None]
    for cls, param in (("MultivariateNormal", cov),
                       ("MultivariateNormalMeanPrecision",
                        np.linalg.inv(cov))):
        dist, env = _build(tdist, Variable, torch.as_tensor, cls,
                           {"mean": (mean, False),
                            "covariance" if cls == "MultivariateNormal"
                            else "precision": (param, False)},
                           np.zeros((1, D)), False)
        del env[dist.random_variable.uuid]
        samples = dist.draw_samples(env, torch.Generator().manual_seed(0),
                                    num_samples=40000).numpy()
        assert samples.shape == (40000, 1, D)
        assert np.allclose(samples[:, 0, :].mean(0), mean[0], atol=0.1)
        assert np.allclose(np.cov(samples[:, 0, :].T), cov[0], rtol=0.1,
                           atol=0.15)


def test_mvn_mean_precision_log_pdf_gradients():
    """d log_pdf / d precision against JAX's gradient (rtol 1e-10) and
    against central finite differences (the JAX test's check)."""
    rng = np.random.default_rng(14)
    D = 3
    mean = rng.standard_normal((1, D))
    prec = make_spd_matrix(D, rng)[None]
    rv = rng.standard_normal((1, D))

    jin = {"mean": JVariable(), "precision": JVariable()}
    jd = jdist.MultivariateNormalMeanPrecision(dtype="float64", **jin)
    jd._generate_outputs(shape=(D,))

    def jlogp(p):
        env = {jin["mean"].uuid: jnp.asarray(mean)[None],
               jin["precision"].uuid: p[None],
               jd.random_variable.uuid: jnp.asarray(rv)[None]}
        return jnp.sum(jd.log_pdf(env))

    tin = {"mean": Variable(), "precision": Variable()}
    td = tdist.MultivariateNormalMeanPrecision(dtype="float64", **tin)
    td._generate_outputs(shape=(D,))

    def tlogp(p):
        env = {tin["mean"].uuid: torch.as_tensor(mean)[None],
               tin["precision"].uuid: p[None],
               td.random_variable.uuid: torch.as_tensor(rv)[None]}
        return torch.sum(td.log_pdf(env))

    p = torch.as_tensor(prec).requires_grad_(True)
    tlogp(p).backward()
    g = p.grad.numpy()
    np.testing.assert_allclose(g, np.asarray(jax.grad(jlogp)(
        jnp.asarray(prec))), rtol=RTOL, atol=1e-13)
    fd = np.zeros_like(prec)
    for idx in np.ndindex(prec.shape):
        e = np.zeros_like(prec)
        e[idx] = 1e-6
        fd[idx] = (float(tlogp(torch.as_tensor(prec + e)))
                   - float(tlogp(torch.as_tensor(prec - e)))) / 2e-6
    np.testing.assert_allclose(g, fd, rtol=1e-5, atol=1e-7)


def test_multivariate_normal_gradients_match_jax():
    """d log_pdf of the covariance form in the mean, the covariance and
    the value, against JAX (rtol 1e-10): the path the SVI bound
    differentiates through the Cholesky's custom backward."""
    rng = np.random.default_rng(15)
    D, B = 4, 3
    vals = {"mean": rng.standard_normal((1, B, D)),
            "covariance": np.stack([make_spd_matrix(D, rng)
                                    for _ in range(B)])[None],
            "rv": rng.standard_normal((2, B, D))}

    jin = {"mean": JVariable(), "covariance": JVariable()}
    jd = jdist.MultivariateNormal(dtype="float64", **jin)
    jd._generate_outputs(shape=(B, D))
    tin = {"mean": Variable(), "covariance": Variable()}
    td = tdist.MultivariateNormal(dtype="float64", **tin)
    td._generate_outputs(shape=(B, D))

    def jlogp(v):
        return jnp.sum(jd.log_pdf({jin["mean"].uuid: v["mean"],
                                   jin["covariance"].uuid: v["covariance"],
                                   jd.random_variable.uuid: v["rv"]}))

    jg = jax.grad(jlogp)({k: jnp.asarray(v) for k, v in vals.items()})
    tv = {k: torch.as_tensor(v).requires_grad_(True) for k, v in
          vals.items()}
    torch.sum(td.log_pdf({tin["mean"].uuid: tv["mean"],
                          tin["covariance"].uuid: tv["covariance"],
                          td.random_variable.uuid: tv["rv"]})).backward()
    for k in vals:
        np.testing.assert_allclose(tv[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=RTOL, atol=1e-13, err_msg=k)


def test_normal_mean_precision_matches_jax():
    rng = np.random.default_rng(16)
    S, N = 3, 5
    mean = rng.standard_normal((N, 1))
    prec = rng.random((N, 1)) + 0.5
    rv = rng.standard_normal((S, N, 1))
    result, jresult = both_log_pdf(
        "NormalMeanPrecision", {"mean": (mean, False),
                                "precision": (prec, False)}, rv, True)
    np.testing.assert_allclose(result, jresult, rtol=RTOL)
    np.testing.assert_allclose(
        result, stats.norm.logpdf(rv, mean, 1 / np.sqrt(prec)), rtol=1e-10)
    noise = rng.standard_normal(S * N)
    out = []
    for dist_mod, Var, to, Fixed, gen in (
            (tdist, Variable, torch.as_tensor, FixedRandomGenerator,
             torch.Generator()),
            (jdist, JVariable, jnp.asarray, JFixed, jax.random.PRNGKey(0))):
        dist, env = _build(dist_mod, Var, to, "NormalMeanPrecision",
                           {"mean": (mean, False),
                            "precision": (prec, False)},
                           np.zeros((N, 1)), False, rand_gen=Fixed(noise))
        del env[dist.random_variable.uuid]
        out.append(np.asarray(dist.draw_samples(env, gen, num_samples=S)))
    np.testing.assert_allclose(out[0], out[1], rtol=RTOL)


@pytest.mark.parametrize("cls", ["MultivariateNormal",
                                 "MultivariateNormalMeanPrecision"])
def test_multivariate_needs_a_shape_and_declares_support(cls):
    dist = getattr(tdist, cls)(Variable(), Variable())
    with pytest.raises(ValueError, match="explicit shape"):
        dist._generate_outputs(shape=None)
    assert getattr(tdist, cls).support == "real"
    assert tdist.NormalMeanPrecision.support == "real"


def test_einsum_broadcasts_a_shared_factor_against_samples():
    """``"...ij,...j->...i"`` of a (1, N, Q, Q) factor and (s, N, Q) noise
    (the MVN draw of a parameter without a sample axis): the forward
    broadcasts, and the factor's gradient sums over the samples back to
    (1, N, Q, Q), as JAX's broadcasting einsum does."""
    rng = np.random.default_rng(17)
    L = rng.standard_normal((1, 6, 3, 3))
    eps = rng.standard_normal((4, 6, 3))
    g = rng.standard_normal((4, 6, 3))
    Lt = torch.as_tensor(L).requires_grad_(True)
    et = torch.as_tensor(eps).requires_grad_(True)
    out = precision.einsum("...ij,...j->...i", Lt, et)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.einsum("...ij,...j->...i", L, eps),
                               rtol=1e-12)
    assert Lt.grad.shape == (1, 6, 3, 3) and et.grad.shape == (4, 6, 3)
    np.testing.assert_allclose(Lt.grad.numpy(), np.einsum(
        "sni,snj->nij", g, eps)[None], rtol=1e-12)
    np.testing.assert_allclose(et.grad.numpy(), np.einsum(
        "nij,sni->snj", L[0], g), rtol=1e-12)


def test_dot_operator_matches_jax():
    """``dot`` (``operator_impl.py:133-135`` in JAX): the PPCA model's
    z·W with (s, N, Q) samples against a (1, Q, D) weight."""
    from mxfusion_tpu.components.functions.operators import dot as jdot
    from mxfusion_tpu_torch.components.functions.operators import dot
    rng = np.random.default_rng(18)
    z = rng.standard_normal((4, 5, 3))
    W = rng.standard_normal((1, 3, 2))
    out = []
    for op, Var, to in ((dot, Variable, torch.as_tensor),
                        (jdot, JVariable, jnp.asarray)):
        a, b = Var(), Var()
        y = op(a, b)
        res = y.factor.eval({a.uuid: to(z), b.uuid: to(W)})
        out.append(np.asarray(res[y.factor.output_names[0]]))
    assert out[0].shape == (4, 5, 2)
    np.testing.assert_allclose(out[0], out[1], rtol=1e-12)
