"""The constrained-latent distributions, their samplers and the
stick-breaking bijector against the JAX package.

For each distribution: the log-pdf and its gradient in every input
(parameters, and the random variable where it is continuous) at seeded
random parameters, float64, rtol 1e-10; draws through the
``FixedRandomGenerator`` doubles of both packages are equal; draws of the
port's own generator have the closed-form moments. ``ops/simplex.py``'s
forward, inverse and log-Jacobian match JAX (large |z| included) and
round-trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special

from mxfusion_tpu.components import distributions as jdist
from mxfusion_tpu.components.distributions.random_gen import \
    FixedRandomGenerator as JFixed
from mxfusion_tpu.components.variables.variable import Variable as JVariable
from mxfusion_tpu.ops import simplex as jsimplex

from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components import distributions as tdist
from mxfusion_tpu_torch.components.distributions.random_gen import \
    FixedRandomGenerator
from mxfusion_tpu_torch.components.variables.variable import Variable
from mxfusion_tpu_torch.ops import simplex as tsimplex


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


RTOL = 1e-10
S, B, K = 4, 3, 5


def _simplex(rng, shape):
    g = rng.gamma(2.0, size=shape)
    return g / g.sum(-1, keepdims=True)


def _case(name):
    """(class name, constructor kwargs, {input: value without the sample
    axis}, random variable with the sample axis, whether the random
    variable is continuous, its event shape, the fixed draws)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    e = (B, 2)
    pos = lambda shape: rng.uniform(0.5, 3.0, shape)      # noqa: E731
    if name == "LogNormal" or name == "LogitNormal":
        rv = rng.uniform(0.05, 0.95, (S,) + e) if name == "LogitNormal" \
            else pos((S,) + e)
        return (name, {}, {"mean": rng.standard_normal(e),
                           "variance": pos(e)}, rv, True, e,
                rng.standard_normal(S * B * 2))
    if name == "StickBreakingNormal":
        return (name, {}, {"mean": rng.standard_normal((B, K - 1)),
                           "variance": pos((B, K - 1))},
                _simplex(rng, (S, B, K)), True, (B, K),
                rng.standard_normal(S * B * (K - 1)))
    if name in ("Gamma", "InverseGamma", "Beta"):
        return (name, {}, {"alpha": pos(e), "beta": pos(e)},
                rng.uniform(0.05, 0.95, (S,) + e) if name == "Beta"
                else pos((S,) + e), True, e, pos(2 * S * B * 2))
    if name == "GammaMeanVariance":
        return (name, {}, {"mean": pos(e), "variance": pos(e)},
                pos((S,) + e), True, e, pos(S * B * 2))
    if name == "Exponential":
        return (name, {}, {"rate": pos(e)}, pos((S,) + e), True, e,
                pos(S * B * 2))
    if name == "Bernoulli":
        return (name, {}, {"prob_true": rng.uniform(0.1, 0.9, e)},
                rng.integers(0, 2, (S,) + e).astype(np.float64), False, e,
                rng.integers(0, 2, S * B * 2).astype(np.float64))
    if name == "Dirichlet":
        return (name, {}, {"alpha": pos((B, K))},
                _simplex(rng, (S, B, K)) * 1.3, True, (B, K),
                pos(S * B * K))
    if name.startswith("Categorical"):
        one_hot = name.endswith("one_hot")
        idx = rng.integers(0, K, (S, B))
        rv = np.eye(K)[idx] if one_hot else idx[..., None].astype(float)
        kw = {"num_classes": K, "one_hot_encoding": one_hot,
              "normalization": not name.endswith("raw")}
        return ("Categorical", kw, {"log_prob": rng.standard_normal((B, K))},
                rv, False, (B, K) if one_hot else (B, 1),
                rng.integers(0, K, S * B).astype(np.float64))
    raise KeyError(name)


NAMES = ["LogNormal", "LogitNormal", "StickBreakingNormal", "Gamma",
         "GammaMeanVariance", "Exponential", "InverseGamma", "Beta",
         "Bernoulli", "Dirichlet", "Categorical", "Categorical_one_hot",
         "Categorical_raw"]


def _build(mod, Var, Fixed, name):
    cls, kw, params, rv, _, shape, draws = _case(name)
    inputs = {k: Var() for k in params}
    dist = getattr(mod, cls)(dtype="float64", rand_gen=Fixed(draws),
                             **kw, **inputs)
    dist._generate_outputs(shape=shape)
    return dist, inputs


def _jax_log_pdf_and_grads(name):
    _, _, params, rv, cont, _, _ = _case(name)
    dist, inputs = _build(jdist, JVariable, JFixed, name)
    names = list(params) + (["random_variable"] if cont else [])

    def f(*args):
        env = {inputs[k].uuid: a[None] for k, a in zip(params, args)}
        env[dist.random_variable.uuid] = args[-1] if cont else jnp.asarray(rv)
        return dist.log_pdf(env)

    args = [jnp.asarray(v) for v in params.values()] + \
        ([jnp.asarray(rv)] if cont else [])
    lp = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a)),
                     argnums=tuple(range(len(args))))(*args)
    return np.asarray(lp), dict(zip(names, map(np.asarray, grads)))


def _torch_log_pdf_and_grads(name):
    _, _, params, rv, cont, _, _ = _case(name)
    dist, inputs = _build(tdist, Variable, FixedRandomGenerator, name)
    args = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    x = torch.tensor(rv, requires_grad=cont)
    env = {inputs[k].uuid: a[None] for k, a in args.items()}
    env[dist.random_variable.uuid] = x
    lp = dist.log_pdf(env)
    lp.sum().backward()
    grads = {k: a.grad.numpy() for k, a in args.items()}
    if cont:
        grads["random_variable"] = x.grad.numpy()
    return lp.detach().numpy(), grads


@pytest.mark.parametrize("name", NAMES)
def test_log_pdf_and_gradients_match_jax(name):
    lp, grads = _torch_log_pdf_and_grads(name)
    jlp, jgrads = _jax_log_pdf_and_grads(name)
    assert lp.shape == jlp.shape and lp.shape[0] == S
    np.testing.assert_allclose(lp, jlp, rtol=RTOL)
    assert grads.keys() == jgrads.keys()
    for k in grads:
        np.testing.assert_allclose(grads[k], jgrads[k], rtol=RTOL,
                                   atol=1e-13, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_fixed_draws_match_jax(name):
    _, _, params, _, _, _, _ = _case(name)
    tdist_, tin = _build(tdist, Variable, FixedRandomGenerator, name)
    jdist_, jin = _build(jdist, JVariable, JFixed, name)
    assert tdist_.support == jdist_.support
    tenv = {tin[k].uuid: torch.tensor(v)[None] for k, v in params.items()}
    jenv = {jin[k].uuid: jnp.asarray(v)[None] for k, v in params.items()}
    draw = tdist_.draw_samples(tenv, torch.Generator(), num_samples=S)
    jdraw = np.asarray(jdist_.draw_samples(jenv, jax.random.PRNGKey(0),
                                           num_samples=S))
    assert tuple(draw.shape) == jdraw.shape
    assert draw.dtype == torch.float64
    np.testing.assert_allclose(draw.numpy(), jdraw, rtol=1e-14, atol=0)


def _moments(name, a, b=None):
    """Closed-form mean and variance of the draws of ``name`` at the
    scalar parameters a, b."""
    if name == "Gamma":
        return a / b, a / b ** 2
    if name == "GammaMeanVariance":
        return a, b
    if name == "Exponential":
        return 1 / a, 1 / a ** 2
    if name == "InverseGamma":
        return b / (a - 1), b ** 2 / ((a - 1) ** 2 * (a - 2))
    if name == "Beta":
        return a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))
    if name == "Bernoulli":
        return a, a * (1 - a)
    if name == "LogNormal":
        return np.exp(a + b / 2), (np.exp(b) - 1) * np.exp(2 * a + b)
    raise KeyError(name)


@pytest.mark.parametrize("name,params", [
    ("Gamma", {"alpha": 2.5, "beta": 1.5}),
    ("GammaMeanVariance", {"mean": 2.0, "variance": 0.5}),
    ("Exponential", {"rate": 2.0}),
    ("InverseGamma", {"alpha": 4.5, "beta": 2.0}),
    ("Beta", {"alpha": 2.0, "beta": 3.0}),
    ("Bernoulli", {"prob_true": 0.3}),
    ("LogNormal", {"mean": 0.2, "variance": 0.25})])
def test_draws_have_the_closed_form_moments(name, params):
    """2^16 draws of the port's own generator: mean and variance within
    six standard errors (the variance's from the fourth central
    moment of the draws)."""
    n = 1 << 16
    inputs = {k: Variable() for k in params}
    dist = getattr(tdist, name)(dtype="float64", **inputs)
    dist._generate_outputs(shape=(1,))
    env = {inputs[k].uuid: torch.full((1, 1), v, dtype=torch.float64)
           for k, v in params.items()}
    x = dist.draw_samples(env, torch.Generator().manual_seed(3),
                          num_samples=n).reshape(-1).numpy()
    mean, var = _moments(name, *params.values())
    m4 = np.mean((x - x.mean()) ** 4)
    assert abs(x.mean() - mean) < 6 * np.sqrt(var / n)
    assert abs(x.var() - var) < 6 * np.sqrt((m4 - var ** 2) / n)


def test_dirichlet_and_categorical_draws_have_the_closed_form_moments():
    n = 1 << 15
    alpha = np.array([0.5, 1.0, 2.0, 4.0])
    a = Variable()
    dist = tdist.Dirichlet(alpha=a, dtype="float64")
    dist._generate_outputs(shape=(4,))
    x = dist.draw_samples({a.uuid: torch.tensor(alpha)[None]},
                          torch.Generator().manual_seed(4),
                          num_samples=n).reshape(n, 4).numpy()
    a0 = alpha.sum()
    mean = alpha / a0
    var = mean * (1 - mean) / (a0 + 1)
    assert np.all(np.abs(x.sum(-1) - 1) < 1e-12)
    assert np.all(np.abs(x.mean(0) - mean) < 6 * np.sqrt(var / n))
    lp = Variable()
    cat = tdist.Categorical(log_prob=lp, num_classes=4, dtype="float64")
    cat._generate_outputs(shape=(1,))
    c = cat.draw_samples({lp.uuid: torch.log(torch.tensor(mean))[None]},
                         torch.Generator().manual_seed(5), num_samples=n)
    freq = np.bincount(c.reshape(-1).long().numpy(), minlength=4) / n
    assert np.all(np.abs(freq - mean) < 6 * np.sqrt(mean * (1 - mean) / n))


def test_gamma_draw_gradient_is_the_implicit_one():
    """d x / d alpha of a gamma draw, holding its uniform fixed, against
    JAX's implicit gradient at the same draws. torch's backward
    (``_standard_gamma_grad``) is an approximation, 1e-4 relative off
    the exact value at these shapes (up to 9e-4 at alpha = 0.1), hence
    5e-4 here; scipy's CDF differenced in alpha agrees with JAX's to
    1e-8."""
    g = torch.Generator().manual_seed(6)
    alpha = torch.tensor([0.7, 2.0, 6.0], dtype=torch.float64,
                         requires_grad=True)
    x = tdist.RandomGenerator().sample_gamma(g, alpha=alpha, shape=(3,),
                                             dtype="float64")
    x.sum().backward()
    a, xv, h = alpha.detach().numpy(), x.detach().numpy(), 1e-6
    exact = np.asarray(jax.lax.random_gamma_grad(a, xv))
    dF = (special.gammainc(a + h, xv) - special.gammainc(a - h, xv)) / (2 * h)
    pdf = np.exp((a - 1) * np.log(xv) - xv - special.gammaln(a))
    np.testing.assert_allclose(-dF / pdf, exact, rtol=1e-8)
    np.testing.assert_allclose(alpha.grad.numpy(), exact, rtol=5e-4)


def test_simplex_bijector_matches_jax_and_round_trips():
    rng = np.random.default_rng(7)
    z = rng.standard_normal((6, K - 1)) * 3.0
    z[0] = [30.0, -30.0, 25.0, -40.0]          # softplus past torch's 20
    tz = torch.tensor(z, requires_grad=True)
    x = tsimplex.forward(tz)
    np.testing.assert_allclose(x.detach().numpy(),
                               np.asarray(jsimplex.forward(jnp.asarray(z))),
                               rtol=RTOL, atol=1e-300)
    ld = tsimplex.log_det_jacobian(tz)
    np.testing.assert_allclose(
        ld.detach().numpy(),
        np.asarray(jsimplex.log_det_jacobian(jnp.asarray(z))), rtol=RTOL)
    ld.sum().backward()
    jg = jax.grad(lambda a: jnp.sum(jsimplex.log_det_jacobian(a)))(
        jnp.asarray(z))
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg), rtol=RTOL)
    xs = _simplex(rng, (6, K))
    zi = tsimplex.inverse(torch.tensor(xs))
    np.testing.assert_allclose(
        zi.numpy(), np.asarray(jsimplex.inverse(jnp.asarray(xs))), rtol=RTOL)
    np.testing.assert_allclose(tsimplex.forward(zi).numpy(), xs, rtol=1e-12)
    np.testing.assert_allclose(x.sum(-1).detach().numpy(), 1.0, rtol=1e-14)
