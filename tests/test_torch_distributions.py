"""The distribution library, its samplers, ``util/special.py`` and the
stick-breaking bijector against the JAX package.

For each distribution: the log-pdf and its gradient in every input
(parameters, and the random variable where it is continuous) at seeded
random parameters, float64, rtol 1e-10; draws through the
``FixedRandomGenerator`` doubles of both packages are equal; draws of the
port's own generator have the closed-form moments. ``ops/simplex.py``'s
forward, inverse and log-Jacobian match JAX (large |z| included) and
round-trip. The gamma draw's gradient in its shape is JAX's implicit one
(``ops/igamma.py``) to 1e-10.
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


def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


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
    if name == "Laplace":
        return (name, {}, {"location": rng.standard_normal(e),
                           "scale": pos(e)},
                rng.standard_normal((S,) + e) * 2, True, e,
                rng.standard_normal(S * B * 2))
    if name == "StudentT":
        return (name, {}, {"degrees_of_freedom": rng.uniform(2.0, 6.0, e),
                           "location": rng.standard_normal(e),
                           "scale": pos(e)},
                rng.standard_normal((S,) + e) * 2, True, e,
                rng.standard_normal(S * B * 2))
    if name == "Uniform":
        return (name, {}, {"low": rng.uniform(-1.0, 0.0, e),
                           "high": rng.uniform(1.0, 2.0, e)},
                # the density is flat in x: no gradient to compare
                rng.uniform(0.0, 0.9, (S,) + e), False, e,
                rng.uniform(0.0, 1.0, S * B * 2))
    if name in ("Poisson", "NegativeBinomial"):
        params = {"rate": pos(e)} if name == "Poisson" else \
            {"mean": pos(e), "dispersion": rng.uniform(0.2, 2.0, e)}
        n = S * B * 2 * (1 if name == "Poisson" else 2)
        return (name, {}, params,
                rng.poisson(2.0, (S,) + e).astype(np.float64), False, e,
                rng.poisson(2.0, n).astype(np.float64))
    if name == "Concrete":
        return (name, {"temperature": 0.7}, {"probs": pos((B, K))},
                _simplex(rng, (S, B, K)), True, (B, K),
                rng.uniform(0.0, 1.0, S * B * K))
    if name == "NormalMixture":
        return (name, {}, {"weights": pos(e + (3,)),
                           "means": rng.standard_normal(e + (3,)) * 2,
                           "variances": pos(e + (3,))},
                rng.standard_normal((S,) + e) * 2, True, e,
                np.concatenate([rng.integers(0, 3, S * B * 2),
                                rng.standard_normal(S * B * 2)]))
    if name == "Wishart":
        A = rng.standard_normal((3, 3))
        return (name, {}, {"degrees_of_freedom": np.array([5.5]),
                           "scale": A @ A.T + np.eye(3)},
                np.stack([_spd(rng, 3) for _ in range(S)]), True, (3, 3),
                np.concatenate([rng.standard_normal(S * 9), pos(S * 3)]))
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
         "Categorical_raw", "Laplace", "StudentT", "Uniform", "Poisson",
         "NegativeBinomial", "Concrete", "NormalMixture", "Wishart"]


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
    if name == "Laplace":
        return a, 2 * b ** 2
    if name == "Uniform":
        return (a + b) / 2, (b - a) ** 2 / 12
    if name == "Poisson":
        return a, a
    if name == "NegativeBinomial":
        return a, a + b * a ** 2
    raise KeyError(name)


@pytest.mark.parametrize("name,params", [
    ("Gamma", {"alpha": 2.5, "beta": 1.5}),
    ("GammaMeanVariance", {"mean": 2.0, "variance": 0.5}),
    ("Exponential", {"rate": 2.0}),
    ("InverseGamma", {"alpha": 4.5, "beta": 2.0}),
    ("Beta", {"alpha": 2.0, "beta": 3.0}),
    ("Bernoulli", {"prob_true": 0.3}),
    ("LogNormal", {"mean": 0.2, "variance": 0.25}),
    ("Laplace", {"location": 0.5, "scale": 1.5}),
    ("Uniform", {"low": -1.0, "high": 3.0}),
    ("Poisson", {"rate": 3.5}),
    ("NegativeBinomial", {"mean": 3.0, "dispersion": 0.5})])
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


GAMMA_ALPHAS = (0.1, 0.7, 2.0, 6.0, 50.0)


def test_gamma_draw_gradient_is_the_implicit_one():
    """d x / d alpha of a gamma draw, holding its uniform fixed, against
    JAX's implicit gradient at the same draws: ``sample_gamma``'s
    backward is ``ops.igamma.random_gamma_grad``, the port of
    ``jax.lax.random_gamma_grad``, to 1e-10 (float64), at alpha 0.7, 2
    and 6 and then at 40 draws of each of GAMMA_ALPHAS. scipy's CDF
    differenced in alpha agrees with JAX's to 1e-8."""
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
    np.testing.assert_allclose(alpha.grad.numpy(), exact, rtol=1e-10)
    alpha = torch.tensor(GAMMA_ALPHAS, dtype=torch.float64).repeat(40)
    alpha.requires_grad_(True)
    x = tdist.RandomGenerator().sample_gamma(g, alpha=alpha,
                                             shape=alpha.shape,
                                             dtype="float64")
    x.sum().backward()
    exact = np.asarray(jax.lax.random_gamma_grad(
        alpha.detach().numpy(), x.detach().numpy()))
    np.testing.assert_allclose(alpha.grad.numpy(), exact, rtol=1e-10,
                               atol=0)


@pytest.mark.parametrize("alpha", GAMMA_ALPHAS)
def test_random_gamma_grad_matches_jax_on_both_branches(alpha):
    """The series (x <= 1 or x <= alpha) and the continued fraction
    (x > 1 and x > alpha), at x on both sides of the switch and at the
    masks: x = 0 gives 0, alpha <= 0 and x < 0 give NaN."""
    from mxfusion_tpu_torch.ops.igamma import random_gamma_grad
    x = np.array([1e-3, 0.5 * alpha, 0.9, 0.999, 1.001, 1.5,
                  0.99 * alpha, alpha, 1.01 * alpha, 3.0 * alpha,
                  alpha + 10.0 * np.sqrt(alpha), 0.0, -1.0])
    a = np.full_like(x, alpha)
    a[-1] = -alpha
    want = np.asarray(jax.lax.random_gamma_grad(a, x))
    got = random_gamma_grad(torch.tensor(a), torch.tensor(x)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert got[-2] == want[-2] == 0.0 and np.isnan(got[-1])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    both = ((x > 1) & (x > alpha)).any() and (~((x > 1) & (x > alpha))).any()
    assert both


def test_studentt_draw_moments_and_gradient():
    """2^16 Student-t draws at nu = 5: mean and variance nu/(nu-2)
    within six standard errors; the draw's gradient in nu flows through
    the implicit gamma gradient and is finite."""
    n = 1 << 16
    nu = torch.tensor(5.0, dtype=torch.float64, requires_grad=True)
    t = tdist.RandomGenerator().sample_studentt(
        torch.Generator().manual_seed(8), nu, location=0.5, scale=2.0,
        shape=(n,), dtype="float64")
    t.abs().mean().backward()
    x = t.detach().numpy()
    var = 4.0 * 5.0 / 3.0
    assert abs(x.mean() - 0.5) < 6 * np.sqrt(var / n)
    m4 = np.mean((x - x.mean()) ** 4)
    assert abs(x.var() - var) < 6 * np.sqrt((m4 - var ** 2) / n)
    assert np.isfinite(float(nu.grad)) and float(nu.grad) < 0.0


def test_concrete_mixture_and_wishart_draws():
    """Concrete: the argmax of a draw is class k with probability p_k.
    NormalMixture: the mixture's mean and variance. Wishart: the mean
    n·S. 2^14 draws each, within six standard errors."""
    n = 1 << 14
    g = torch.Generator().manual_seed(9)
    p = np.array([0.1, 0.2, 0.3, 0.4])
    pv = Variable()
    conc = tdist.Concrete(probs=pv, temperature=0.5, dtype="float64")
    conc._generate_outputs(shape=(4,))
    x = conc.draw_samples({pv.uuid: torch.tensor(p)[None]}, g,
                          num_samples=n).reshape(n, 4).numpy()
    freq = np.bincount(x.argmax(-1), minlength=4) / n
    assert np.all(np.abs(freq - p) < 6 * np.sqrt(p * (1 - p) / n))
    w, mu, v = np.array([0.3, 0.7]), np.array([-2.0, 1.0]), \
        np.array([0.5, 2.0])
    ins = {k: Variable() for k in ("weights", "means", "variances")}
    mix = tdist.NormalMixture(dtype="float64", **ins)
    mix._generate_outputs(shape=(1,))
    env = {ins[k].uuid: torch.tensor(a)[None, None]
           for k, a in zip(ins, (w, mu, v))}
    x = mix.draw_samples(env, g, num_samples=n).reshape(-1).numpy()
    mean = w @ mu
    var = w @ (v + mu ** 2) - mean ** 2
    assert abs(x.mean() - mean) < 6 * np.sqrt(var / n)
    dof, sv = Variable(), Variable()
    wis = tdist.Wishart(degrees_of_freedom=dof, scale=sv, dtype="float64")
    wis._generate_outputs(shape=(3, 3))
    S_ = _spd(np.random.default_rng(10), 3) / 3
    W = wis.draw_samples({dof.uuid: torch.tensor([[6.0]]),
                          sv.uuid: torch.tensor(S_)[None]}, g,
                         num_samples=n).numpy()
    var = 6.0 * (S_ ** 2 + np.outer(np.diag(S_), np.diag(S_)))
    assert np.all(np.abs(W.mean(0) - 6.0 * S_) < 6 * np.sqrt(var / n))


def test_wishart_nan_pattern_as_jax():
    """A scale that is not positive definite (one of two samples): the
    log-pdf and the draws are NaN for that sample only, in both
    packages."""
    rng = np.random.default_rng(11)
    good = _spd(rng, 3)
    bad = good.copy()
    bad[0, 1] = bad[1, 0] = 10.0 * bad[0, 0]
    scale = np.stack([good, bad])
    X = np.stack([_spd(rng, 3), _spd(rng, 3)])
    out = {}
    for mod, Var, Fixed, arr in ((tdist, Variable, FixedRandomGenerator,
                                  torch.tensor),
                                 (jdist, JVariable, JFixed, jnp.asarray)):
        dof, sv = Var(), Var()
        draws = np.concatenate([rng.standard_normal(18), np.ones(6)]) \
            if mod is tdist else out["draws"]
        out["draws"] = draws
        dist = mod.Wishart(degrees_of_freedom=dof, scale=sv,
                           dtype="float64", rand_gen=Fixed(draws))
        dist._generate_outputs(shape=(3, 3))
        env = {dof.uuid: arr(np.array([[5.0]])), sv.uuid: arr(scale)}
        lp = dist.log_pdf(dict(env, **{dist.random_variable.uuid: arr(X)}))
        d = dist.draw_samples(env, torch.Generator() if mod is tdist
                              else jax.random.PRNGKey(0), num_samples=2)
        out[mod.__name__] = (np.asarray(lp), np.asarray(d))
    (tlp, td), (jlp, jd) = out[tdist.__name__], out[jdist.__name__]
    assert np.isnan(tlp).tolist() == np.isnan(jlp).tolist() == [False, True]
    np.testing.assert_allclose(tlp[0], jlp[0], rtol=RTOL)
    assert np.array_equal(np.isnan(td), np.isnan(jd))
    assert np.isnan(td[1]).all() and not np.isnan(td[0]).any()


def test_special_functions_match_jax():
    """``util/special.py``: values and gradients in float64, rtol 1e-10."""
    from mxfusion_tpu.util import special as jspecial
    from mxfusion_tpu_torch.util import special as tspecial
    rng = np.random.default_rng(12)
    A = np.stack([_spd(rng, 4) for _ in range(3)])
    b = rng.standard_normal((3, 4, 2))
    L = np.linalg.cholesky(A)
    x = rng.uniform(2.0, 5.0, 3)
    cases = [
        ("log_determinant", lambda m, a, b_, x_: m.log_determinant(a)),
        ("log_multivariate_gamma",
         lambda m, a, b_, x_: m.log_multivariate_gamma(x_, 4)),
        ("solve_posdef", lambda m, a, b_, x_: m.solve_posdef(a, b_)),
        ("trace", lambda m, a, b_, x_: m.trace(a)),
        ("solve_triangular", lambda m, a, b_, x_: m.solve_triangular(
            a, b_)),
        ("solve_triangular_trans", lambda m, a, b_, x_: m.solve_triangular(
            a, b_, trans=True)),
        ("solve_triangular_upper", lambda m, a, b_, x_: m.solve_triangular(
            a, b_, lower=False))]
    for name, f in cases:
        a0 = L if name.startswith("solve_triangular") else A
        if name == "solve_triangular_upper":
            a0 = np.swapaxes(L, -1, -2)
        jv, jg = jax.value_and_grad(
            lambda a, b_, x_: jnp.sum(jnp.sin(f(jspecial, a, b_, x_))),
            argnums=(0, 1, 2))(jnp.asarray(a0), jnp.asarray(b),
                               jnp.asarray(x))
        args = [torch.tensor(v, requires_grad=True) for v in (a0, b, x)]
        tv = torch.sum(torch.sin(f(tspecial, *args)))
        tv.backward()
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL,
                                   err_msg=name)
        for t, j in zip(args, jg):
            j = np.asarray(j)
            got = np.zeros_like(j) if t.grad is None else t.grad.numpy()
            np.testing.assert_allclose(got, j, rtol=RTOL,
                                       atol=RTOL * (np.abs(j).max() + 1e-300),
                                       err_msg=name)


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
