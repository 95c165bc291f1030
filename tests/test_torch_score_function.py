"""Per-sample log densities, the score-function (BBVI) estimators, IWAE
and the expectation algorithms against the JAX package.

Each loss algorithm runs once in both packages from the same carried
state on the same fixed draws (``test_torch_meanfield.pair``): the
reported loss, the loss that is differentiated and its gradient in
every trainable parameter agree at rtol 1e-8, float64. The expectation
algorithms run through the sampling executor on fixed draws of the
model's own factors."""
import jax
import numpy as np
import pytest
import torch

from mxfusion_tpu import inference as jinference
from mxfusion_tpu.inference import (
    create_executor as jcreate_executor,
    create_sampling_executor as jcreate_sampling_executor)

from mxfusion_tpu_torch import inference as tinference
from mxfusion_tpu_torch.inference import (create_executor,
                                          create_sampling_executor)
from mxfusion_tpu_torch.util.carryover import name_paths

# _on_the_cpu_in_float64 is the autouse fixture of these tests too
from test_torch_meanfield import (  # noqa: F401
    J, T, JInference, GradBasedInference, _on_the_cpu_in_float64,
    dirichlet_categorical, jax_f64, normal_with_gamma_variance, pair)

ALGORITHMS = ["StochasticVariationalInference", "ScoreFunctionInference",
              "ScoreFunctionRBInference",
              "ImportanceWeightedVariationalInference"]
MODELS = {"normal_gamma": normal_with_gamma_variance,
          "dirichlet": dirichlet_categorical}


def _data_list(alg, data):
    return [data[v.name] for v in alg.observed_variables]


def _jax_loss_and_grads(jinf, data):
    alg = jinf.inference_algorithm
    ex = jcreate_executor(alg, jinf.params)
    fixed = dict(jinf.params.fixed_params())

    def f(tr):
        loss, for_grad, _ = ex(tr, fixed, _data_list(alg, data),
                               jax.random.PRNGKey(0))
        return for_grad, loss

    (for_grad, loss), grads = jax.value_and_grad(f, has_aux=True)(
        dict(jinf.params.trainable_params()))
    paths = name_paths(jinf.graphs)
    return float(loss), float(for_grad), {
        paths[k]: np.asarray(g) for k, g in grads.items()}


def _torch_loss_and_grads(tinf, data):
    alg = tinf.inference_algorithm
    ex = create_executor(alg, tinf.params)
    train = {k: v.clone().requires_grad_(True)
             for k, v in tinf.params.trainable_params().items()}
    loss, for_grad, _ = ex(train, tinf.params.fixed_params(),
                           _data_list(alg, data), torch.Generator())
    for_grad.backward()
    paths = name_paths(tinf.graphs)
    return float(loss.detach()), float(for_grad.detach()), {
        paths[k]: v.grad.numpy() for k, v in train.items()}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_loss_and_gradients_match_jax(algorithm, model):
    data, jinf, tinf = pair(
        MODELS[model], S=6, key=1, fixed=True,
        Alg=(getattr(jinference, algorithm),
             getattr(tinference, algorithm)))
    tl, tg, tgrads = _torch_loss_and_grads(tinf, data)
    jl, jg, jgrads = _jax_loss_and_grads(jinf, data)
    np.testing.assert_allclose([tl, tg], [jl, jg], rtol=1e-8)
    assert tgrads.keys() == jgrads.keys() and len(tgrads) >= 2
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=1e-8,
                                   atol=1e-12, err_msg=k)


def test_iwae_bound_is_above_the_elbo_and_bbvi_reports_the_elbo():
    """On the same draws the IWAE bound is at least the mean of the
    per-sample ELBO terms (Jensen), and both BBVI estimators report that
    ELBO as their loss."""
    losses = {}
    for algorithm in ALGORITHMS:
        data, _, tinf = pair(
            normal_with_gamma_variance, S=6, key=1, fixed=True,
            Alg=(getattr(jinference, algorithm),
                 getattr(tinference, algorithm)))
        losses[algorithm] = _torch_loss_and_grads(tinf, data)[0]
    elbo = -losses["StochasticVariationalInference"]
    assert -losses["ImportanceWeightedVariationalInference"] >= elbo
    np.testing.assert_allclose(losses["ScoreFunctionInference"], -elbo,
                               rtol=1e-12)
    np.testing.assert_allclose(losses["ScoreFunctionRBInference"], -elbo,
                               rtol=1e-12)


def test_log_pdf_per_sample_matches_jax():
    """The joint, a target subset and the empty target set, per sample,
    on a posterior draw of six samples against the model's size-1
    constants."""
    data, jinf, tinf = pair(normal_with_gamma_variance, S=6, key=2,
                            fixed=True)
    out = []
    for inf, ex, gen, pkg in (
            (jinf, jcreate_executor, jax.random.PRNGKey(0), "jax"),
            (tinf, create_executor, torch.Generator(), "torch")):
        alg = inf.inference_algorithm
        build_env = ex(alg, inf.params).build_env
        env = build_env(inf.params.trainable_params(),
                        inf.params.fixed_params(), _data_list(alg, data))
        q, m = alg.posterior, alg.model
        env.update(q.draw_samples(env, gen, num_samples=6))
        likelihood = [m.y.uuid]
        res = [m.log_pdf_per_sample(env), q.log_pdf_per_sample(env),
               m.log_pdf_per_sample(env, targets=likelihood),
               m.log_pdf_per_sample(env, targets=[])]
        out.append([np.asarray(r.detach() if pkg == "torch" else r)
                    for r in res])
    for t, j in zip(*out):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=1e-12)
    assert out[0][0].shape == (6,) and out[0][3].shape == (1,)
    assert not out[1][3].any()


def expectation_model(P):
    """tau ~ Gamma(a, b) and mu ~ Normal(c, 1) with trainable a, b, c,
    and f = log(tau) spread over three entries: the target of the
    score-function expectation."""
    m = P.pkg.Model()
    m.a = P.pkg.Variable(transformation=P.Positive(), initial_value=2.0)
    m.b = P.pkg.Variable(transformation=P.Positive(), initial_value=1.5)
    m.c = P.pkg.Variable(shape=(1,), initial_value=0.3)
    m.tau = P.dist.Gamma.define_variable(alpha=m.a, beta=m.b, shape=(1,))
    m.mu = P.dist.Normal.define_variable(mean=m.c, variance=1., shape=(1,))
    m.f = P.ops.log(P.ops.broadcast_to(m.tau, (3, 1)))
    for i, v in enumerate((m.tau, m.mu)):
        v.factor._rand_gen = P.Fixed(
            np.random.default_rng(i).uniform(0.2, 2.0, 8))
    return m


@pytest.mark.parametrize("algorithm", ["ExpectationAlgorithm",
                                       "ExpectationScoreFunctionAlgorithm"])
def test_expectation_algorithms_match_jax(algorithm):
    """Eight fixed draws of each latent: the outputs, and for the
    score-function expectation the gradient of its surrogate in a, b
    and c, rtol 1e-8."""
    with jax_f64():
        jm = expectation_model(J)
        jalg = getattr(jinference, algorithm)(
            model=jm, observed=[], num_samples=8, target_variables=[jm.f])
        jinf = JInference(jalg, dtype="float64")
        jinf.initialize(key=jax.random.PRNGKey(0))
    tm = expectation_model(T)
    talg = getattr(tinference, algorithm)(
        model=tm, observed=[], num_samples=8, target_variables=[tm.f])
    tinf = GradBasedInference(talg, dtype="float64", device="cpu")
    tinf.initialize()
    jex = jcreate_sampling_executor(jalg, jinf.params)
    tex = create_sampling_executor(talg, tinf.params)
    jtrain = dict(jinf.params.trainable_params())
    ttrain = {k: v.clone().requires_grad_(True)
              for k, v in tinf.params.trainable_params().items()}
    with jax_f64():
        jout = jex(jtrain, jinf.params.fixed_params(), [],
                   jax.random.PRNGKey(0))
    tout = tex(ttrain, tinf.params.fixed_params(), [], torch.Generator())
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-8)
    if algorithm == "ExpectationAlgorithm":
        return
    jgrads = jax.grad(lambda tr: jex(tr, jinf.params.fixed_params(), [],
                                     jax.random.PRNGKey(0))[1])(jtrain)
    tout[1].backward()
    jpaths, tpaths = name_paths([jm]), name_paths([tm])
    jgrads = {jpaths[k]: np.asarray(g) for k, g in jgrads.items()}
    assert sorted(jgrads) == ["a", "b", "c"]
    for k, v in ttrain.items():
        np.testing.assert_allclose(v.grad.numpy(), jgrads[tpaths[k]],
                                   rtol=1e-8, atol=1e-12,
                                   err_msg=tpaths[k])
