"""The keyed gamma and Poisson draws (``ops/keyed_random.py``: R1, R2).

On the CPU every draw is the plain version. The plain Threefry-2x32
equals ``jax.extend.random.threefry_2x32`` bit for bit; a draw depends
only on (key, element index); 2^16 gamma draws at GAMMA_ALPHAS pass a
Kolmogorov-Smirnov test against ``scipy.stats.gamma`` (p > 1e-3) and
float32 gives no zero or inf; 2^16 Poisson draws at the rates that
``chip_smoke.py`` phase 58 draws have the mean and the variance of the
law within six standard errors and every frequency whose expected count
reaches 20 within six of its pmf; the edge cases (α ≤ 0, NaN, rate 0,
rate < 0) are JAX's; each draw takes exactly one key from the caller's
generator; the operators' CPU implementation is the plain version and
counts no launch; Beta, Dirichlet, Student-t, NegativeBinomial and
Wishart draws, all gamma draws underneath, have their moments within six
standard errors. The tests marked ``cuda`` hold R1 and R2 to their plain
versions on the card (the raw words and the gamma draws at GAMMA_ALPHAS,
Poisson at phase 58's rates, float32 and float64). JAX is imported only
inside the CPU tests that compare with it, so the card's tests run
without it (on a machine without JAX the tests that compare with it
skip).
"""
import math

import numpy as np
import pytest
import torch
from scipy import stats

from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components import distributions as tdist
from mxfusion_tpu_torch.components.distributions.random_gen import \
    RandomGenerator
from mxfusion_tpu_torch.components.variables.variable import Variable
from mxfusion_tpu_torch.ops import keyed_random as kr

GAMMA_ALPHAS = (0.1, 0.7, 2.0, 6.0, 50.0)
POISSON_RATES = (0.3, 4.0, 9.99, 10.0, 37.0, 1e4)
DTYPES = (torch.float32, torch.float64)
N = 1 << 16


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Each round is a few dozen small elementwise passes: torch's
    intra-op threads would only contend with the suite's other workers
    for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _key(seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, 2 ** 32, 2, dtype=np.int64))


@pytest.mark.parametrize("seed", range(8))
def test_plain_threefry_is_jax_bit_for_bit(seed):
    """4096 counter pairs under one of 8 keys: JAX's layout pairs
    (x0[i], x1[i]) of ``count = concat(x0, x1)`` and returns
    ``concat(y0, y1)``."""
    jnp = pytest.importorskip("jax.numpy")
    from jax.extend.random import threefry_2x32
    rng = np.random.default_rng(100 + seed)
    key = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, 2 * 4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(threefry_2x32(jnp.asarray(key), jnp.asarray(x)))
    y0, y1 = kr.threefry2x32(torch.as_tensor(key.astype(np.int64)),
                             torch.as_tensor(x[:4096].astype(np.int64)),
                             torch.as_tensor(x[4096:].astype(np.int64)))
    got = np.concatenate([y0.numpy(), y1.numpy()])
    assert got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("draw,params", [
    (kr._gamma_torch, (0.1, 0.7, 2.0, 50.0)),
    (kr._poisson_torch, (0.3, 9.99, 10.0, 1e4))])
def test_a_draw_depends_only_on_key_and_index(draw, params):
    """A slice of a 4096-element draw equals the draw of the slice's
    indices alone and does not move when the parameters outside it
    change; another key gives other values."""
    rng = np.random.default_rng(5)
    p = torch.as_tensor(rng.choice(params, 4096))
    key = _key(1)
    whole = draw(p, key)
    part = draw(p[1000:1500], key, index=torch.arange(1000, 1500))
    np.testing.assert_array_equal(part.numpy(), whole[1000:1500].numpy())
    moved = p.clone()
    moved[:1000] = moved[:1000] * 1.5 + 1.0
    np.testing.assert_array_equal(draw(moved, key)[1000:].numpy(),
                                  whole[1000:].numpy())
    other = draw(p, _key(2))
    assert (other != whole).float().mean() > 0.5
    assert torch.isfinite(whole).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("alpha", GAMMA_ALPHAS)
def test_gamma_draws_follow_the_gamma_law(alpha, dtype):
    """2^16 draws at one α: Kolmogorov-Smirnov against Gamma(α, 1) at
    p > 1e-3; no zero or inf (float32 at α = 0.1 underflows below its
    tiny without the clamp)."""
    x = kr.keyed_standard_gamma(torch.full((N,), alpha, dtype=dtype),
                                _key(int(alpha * 10) + 3))
    assert x.dtype == dtype and x.shape == (N,)
    assert torch.isfinite(x).all() and (x > 0).all()
    p = stats.kstest(x.double().numpy(), stats.gamma(alpha).cdf).pvalue
    assert p > 1e-3, p


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", POISSON_RATES)
def test_poisson_draws_follow_the_poisson_law(rate, dtype):
    """2^16 draws at one rate: the mean within six standard errors of
    the rate, the variance within six of it (the sample variance's
    standard error sqrt((λ + 2λ²)/n)), and every count whose expected
    number reaches 20 within six standard errors of its pmf."""
    x = kr.keyed_poisson(torch.full((N,), rate, dtype=dtype),
                         _key(int(rate) + 11)).double().numpy()
    assert np.all(x == np.round(x)) and x.min() >= 0
    assert abs(x.mean() - rate) < 6 * math.sqrt(rate / N)
    assert abs(x.var() - rate) < 6 * math.sqrt((rate + 2 * rate ** 2) / N)
    k = np.arange(int(x.max()) + 1)
    pmf = stats.poisson(rate).pmf(k)
    freq = np.bincount(x.astype(np.int64), minlength=k.size) / N
    seen = pmf * N >= 20
    assert seen.sum() >= 2
    np.testing.assert_array_less(
        np.abs(freq - pmf)[seen], 6 * np.sqrt(pmf * (1 - pmf) / N)[seen])


@pytest.mark.parametrize("dtype", DTYPES)
def test_edge_cases_as_jax(dtype):
    """α = 0 gives 0, -2/3 < α < 0 a finite positive value, α ≤ -2/3 and
    NaN give NaN and α = inf gives inf, in both packages; α = 1e-30 is
    the clamp's tiny here where JAX underflows to 0 (the one difference:
    no zero at α > 0). Rate 0 and 1e-30 give 0, a negative or NaN rate
    -1, as JAX's."""
    jax = pytest.importorskip("jax")  # float64: tests/conftest.py
    jdt = {torch.float32: "float32", torch.float64: "float64"}[dtype]
    alphas = [0.0, -0.3, -0.5, -0.7, -1.0, -2.0, math.nan, math.inf, 1e-30]
    got = kr.keyed_standard_gamma(torch.tensor(alphas, dtype=dtype),
                                  _key(7)).numpy()
    want = np.asarray(jax.random.gamma(
        jax.random.PRNGKey(7), np.asarray(alphas, dtype=jdt), dtype=jdt))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert got[0] == want[0] == 0.0
    assert np.all(np.isfinite(got[1:3]) & (got[1:3] > 0)
                  & np.isfinite(want[1:3]) & (want[1:3] > 0))
    assert got[7] == want[7] == np.inf
    assert got[8] == np.finfo(jdt).tiny and want[8] == 0.0
    rates = [0.0, -1.0, -20.0, math.nan, 1e-30]
    got = kr.keyed_poisson(torch.tensor(rates, dtype=dtype), _key(8))
    want = np.asarray(jax.random.poisson(jax.random.PRNGKey(8),
                                         np.asarray(rates, dtype=jdt)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float64))


def test_each_draw_takes_one_key_from_the_generator():
    """``sample_gamma`` and ``sample_poisson`` advance the generator by
    one (2,) key draw and draw what the operator draws under that key;
    a Student-t draw takes a normal draw and one key."""
    g = torch.Generator().manual_seed(3)
    ref = torch.Generator().manual_seed(3)
    x = RandomGenerator().sample_gamma(g, alpha=2.5, beta=2.0, shape=(7,),
                                       dtype="float64")
    key = torch.randint(0, 2 ** 32, (2,), generator=ref, dtype=torch.int64)
    assert torch.equal(g.get_state(), ref.get_state())
    np.testing.assert_array_equal(x.numpy(), kr.keyed_standard_gamma(
        torch.full((7,), 2.5, dtype=torch.float64), key).numpy() / 2.0)
    c = RandomGenerator().sample_poisson(g, rate=torch.tensor([3.0, 30.0]),
                                         shape=(2,), dtype="float32")
    key = torch.randint(0, 2 ** 32, (2,), generator=ref, dtype=torch.int64)
    assert torch.equal(g.get_state(), ref.get_state())
    assert c.dtype == torch.float32
    np.testing.assert_array_equal(c.numpy(), kr.keyed_poisson(
        torch.tensor([3.0, 30.0]), key).numpy())
    RandomGenerator().sample_studentt(g, 2.5, shape=(4,), dtype="float64")
    torch.randn((4,), generator=ref, dtype=torch.float64)
    torch.randint(0, 2 ** 32, (2,), generator=ref, dtype=torch.int64)
    assert torch.equal(g.get_state(), ref.get_state())


def test_cpu_operators_are_the_plain_versions():
    """On a CPU tensor each operator is its plain version and counts no
    launch; the fake implementations give the parameter's shape and
    type; a key that is not int64 (2,) raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    key = _key(4)
    a = torch.tensor([[0.5, 3.0], [7.0, 0.2]], dtype=torch.float64)
    before = (kr.keyed_standard_gamma.launches, kr.keyed_poisson.launches)
    np.testing.assert_array_equal(
        torch.ops.mxfusion_tpu_torch.keyed_gamma(a, key).numpy(),
        kr._gamma_torch(a, key).numpy())
    np.testing.assert_array_equal(
        torch.ops.mxfusion_tpu_torch.keyed_poisson(a * 5, key).numpy(),
        kr._poisson_torch(a * 5, key).numpy())
    assert (kr.keyed_standard_gamma.launches,
            kr.keyed_poisson.launches) == before
    with FakeTensorMode():
        fa = torch.empty((3, 4), dtype=torch.float32)
        fk = torch.empty((2,), dtype=torch.int64)
        for op in (torch.ops.mxfusion_tpu_torch.keyed_gamma,
                   torch.ops.mxfusion_tpu_torch.keyed_poisson):
            out = op(fa, fk)
            assert out.shape == (3, 4) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="int64 of shape"):
        kr.keyed_standard_gamma(a, key.to(torch.int32))
    with pytest.raises(ValueError, match="float32 or float64"):
        kr.keyed_poisson(a.to(torch.float16), key)


def _drawn(cls, shape, n, seed, **params):
    """``n`` draws of ``cls`` (float64) with its inputs set to
    ``params``."""
    ins = {k: Variable() for k in params}
    dist = cls(dtype="float64", **ins)
    dist._generate_outputs(shape=shape)
    env = {ins[k].uuid: torch.as_tensor(v, dtype=torch.float64)[None]
           for k, v in params.items()}
    return dist.draw_samples(env, torch.Generator().manual_seed(seed),
                             num_samples=n).numpy()


def _within(x, mean, var, n):
    """Means and variances of the draws ``x`` (n, ...) within six
    standard errors (the variance's from the draws' fourth moment)."""
    m4 = np.mean((x - x.mean(0)) ** 4, axis=0)
    assert np.all(np.abs(x.mean(0) - mean) < 6 * np.sqrt(var / n))
    assert np.all(np.abs(x.var(0) - var) < 6 * np.sqrt((m4 - var ** 2) / n))


@pytest.mark.parametrize("name", ["Beta", "Dirichlet", "StudentT",
                                  "NegativeBinomial", "Wishart"])
def test_distribution_draws_moments(name):
    """2^15 draws of each distribution that draws through the keyed
    gamma (and Poisson) draws: means and variances within six standard
    errors of the closed forms."""
    n = 1 << 15
    if name == "Beta":
        a, b = np.array([0.5, 2.0, 7.0]), np.array([0.7, 3.0, 0.9])
        x = _drawn(tdist.Beta, (3,), n, 1, alpha=a, beta=b).reshape(n, 3)
        _within(x, a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1)), n)
    elif name == "Dirichlet":
        a = np.array([0.3, 1.0, 4.0, 10.0])
        x = _drawn(tdist.Dirichlet, (4,), n, 2, alpha=a).reshape(n, 4)
        a0 = a.sum()
        _within(x, a / a0, a * (a0 - a) / (a0 ** 2 * (a0 + 1)), n)
    elif name == "StudentT":
        nu, loc, scale = 6.5, 0.5, 2.0
        x = _drawn(tdist.StudentT, (1,), n, 3, degrees_of_freedom=[nu],
                   location=[loc], scale=[scale]).reshape(n)
        var = scale ** 2 * nu / (nu - 2)
        assert abs(x.mean() - loc) < 6 * math.sqrt(var / n)
        # the t's fourth moment is finite at ν > 4
        m4 = 3 * nu ** 2 / ((nu - 2) * (nu - 4)) * scale ** 4
        assert abs(x.var() - var) < 6 * math.sqrt((m4 - var ** 2) / n)
    elif name == "NegativeBinomial":
        mu, alpha = np.array([0.4, 3.0, 25.0]), np.array([0.5, 0.5, 2.0])
        x = _drawn(tdist.NegativeBinomial, (3,), n, 4, mean=mu,
                   dispersion=alpha).reshape(n, 3)
        assert np.all(x == np.round(x)) and x.min() >= 0
        _within(x, mu, mu + alpha * mu ** 2, n)
    else:
        rng = np.random.default_rng(10)
        A = rng.standard_normal((3, 3))
        S = (A @ A.T + 3 * np.eye(3)) / 9
        W = _drawn(tdist.Wishart, (3, 3), n, 5, degrees_of_freedom=[6.0],
                   scale=S).reshape(n, 3, 3)
        var = 6.0 * (S ** 2 + np.outer(np.diag(S), np.diag(S)))
        _within(W, 6.0 * S, var, n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_threefry_kernel_is_the_plain_version_on_the_card(card):
    """2^20 counters: the kernel's raw words equal the plain version's."""
    g = torch.Generator(card).manual_seed(0)
    key = torch.randint(0, 2 ** 32, (2,), generator=g, device=card)
    x0 = torch.arange(1 << 20, device=card)
    x1 = torch.randint(0, 2 ** 32, (1 << 20,), generator=g, device=card)
    got = kr.threefry2x32(key, x0, x1)
    want = kr._threefry_torch(key[0], key[1], x0, x1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_keyed_kernels_are_the_plain_versions_on_the_card(card, dtype):
    """R1 at GAMMA_ALPHAS and R2 at phase 58's rates, 2^14 elements of
    each, equal their plain versions on the card: to the bit, or within
    1e-6 relative with at most 1e-5 of the elements accepted in another
    round (counted here by values farther apart); one launch each."""
    key = torch.tensor([17, 2 ** 31 + 5], device=card)
    for draw, plain, params in (
            (kr.keyed_standard_gamma, kr._gamma_torch, GAMMA_ALPHAS),
            (kr.keyed_poisson, kr._poisson_torch, POISSON_RATES)):
        p = torch.tensor(params, dtype=dtype, device=card).repeat_interleave(
            1 << 14)
        before = draw.launches
        got = draw(p, key)
        assert draw.launches == before + 1
        want = plain(p, key)
        close = (got - want).abs() <= 1e-6 * want.abs()
        assert torch.isfinite(got).all()
        assert (~close).float().mean() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_broadcast_parameter_draws_as_a_dense_one_on_the_card(card, dtype):
    """A parameter broadcast from one value, as the samplers pass it (read
    in place at stride 0), draws what the same value written out draws:
    to the bit."""
    key = torch.tensor([3, 2 ** 32 - 7], device=card)
    for draw, p in ((kr.keyed_standard_gamma, 2.5), (kr.keyed_poisson, 37.0)):
        one = torch.full((1, 1), p, dtype=dtype, device=card)
        dense = torch.full((64, 1024), p, dtype=dtype, device=card)
        assert torch.equal(draw(torch.broadcast_to(one, (64, 1024)), key),
                           draw(dense, key))


# two pows each within 2 ulps of the exact value differ by up to 4 ulps;
# times the unboosted draw that is up to 8 of the product's ulps, 9 after
# each product's rounding
F64_GAMMA_ULPS = 9


def _equal_or_ulps(got, want, ulps):
    """Every element bit-equal (NaN where NaN), or at most ``ulps``
    representable values apart (by the bits of nonnegative draws)."""
    same = (got == want) | (got.isnan() & want.isnan())
    if ulps:
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}[
            got.dtype]
        same |= (got.view(bits).long() - want.view(bits).long()).abs() <= \
            ulps
    return bool(same.all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_and_short_tiles_are_the_plain_versions_on_the_card(card,
                                                                   dtype):
    """R1 and R2 on mixed dense parameters (the roundless rates 0, -1
    and NaN among them) at n below 32, at one tile of 32 for every
    resident warp, and at an n that is no multiple of R1's tile (its
    last tile ragged; R2's tiles of 32 more than its resident warps, the
    last of 5): float32 draws and every count bit-equal to the plain versions,
    float64 gamma within F64_GAMMA_ULPS (the boost's pow, within 2 ulps
    of the exact value in CUDA's double-precision library, is built
    without FMA contraction here and with it in torch)."""
    key = torch.tensor([99, 2 ** 31 - 3], device=card)
    _, warps = kr.launch_plan("gamma", dtype, 1)
    big = 3 * (1 << 20) + 5
    tile, _ = kr.launch_plan("gamma", dtype, big)
    assert big % tile != 0 and tile > 32
    assert kr.launch_plan("poisson", dtype, big)[0] == 32
    for n in (1, 7, 31, 32 * warps, big):
        rng = np.random.default_rng([12, n])
        for draw, plain, values in (
                (kr.keyed_standard_gamma, kr._gamma_torch,
                 (0.1, 0.7, 2.5, 50.0)),
                (kr.keyed_poisson, kr._poisson_torch,
                 (0.0, -1.0, math.nan, 0.3, 4.0, 9.99, 10.0, 37.0, 1e4))):
            p = torch.as_tensor(rng.choice(values, n), dtype=dtype,
                                device=card)
            want = plain(p, key)
            got = draw(p, key)
            gamma64 = draw is kr.keyed_standard_gamma and \
                dtype == torch.float64
            assert _equal_or_ulps(got, want,
                                  F64_GAMMA_ULPS if gamma64 else 0), (
                n, draw.__name__)
