"""Bayesian NN, VAE and Concrete VAE against the JAX package, float64 on
the CPU, and the BNN's zips within the port and across packages.

The models are BASELINE config 5's (``benchmarks/bnn_vae_dp.py``,
``examples/bnn_regression.py``, ``examples/variational_auto_encoder.py``)
and the Concrete VAE of ``tests/components/distributions/
test_concrete.py``, at small widths. Their networks are laid out as
flax's, so the lifted weights carry flax's names in both packages. The
JAX package initializes the state, every parameter is moved off it by
seeded draws, and ``util.carryover.load_state`` carries it into the port
by name path. Each posterior latent draws from a ``FixedRandomGenerator``
over its own buffer, seeded by the latent's name path (never by
position: flax orders the weights by sorted path, torch by
registration), so both packages evaluate the negative ELBO on the same
draws: rtol 1e-10. The port's default dtype is float64 here, as the
mean-field tests set it: the mean-field factors take it."""
import zlib
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxfusion_tpu as mj
from mxfusion_tpu import inference as jinference
from mxfusion_tpu.components import distributions as jdist
from mxfusion_tpu.components.distributions.random_gen import \
    FixedRandomGenerator as JFixed
from mxfusion_tpu.components.functions import FlaxFunction
from mxfusion_tpu.components.functions import operators as jops
from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch import inference as tinference
from mxfusion_tpu_torch.components import distributions as tdist
from mxfusion_tpu_torch.components.distributions.random_gen import \
    FixedRandomGenerator
from mxfusion_tpu_torch.components.functions import NNFunction
from mxfusion_tpu_torch.components.functions import operators as tops
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.util.carryover import load_state, name_paths

from tests.test_torch_nn_function import Dense, FlaxMLP, MLP
from tests.test_torch_meanfield import _on_the_cpu_in_float64  # noqa: F401
from tests.test_torch_svgp_classification import by_path, jax_f64

RTOL = 1e-10
J = SimpleNamespace(pkg=mj, dist=jdist, ops=jops, inf=jinference,
                    Positive=JPositive, Fixed=JFixed)
T = SimpleNamespace(pkg=mt, dist=tdist, ops=tops, inf=tinference,
                    Positive=PositiveTransformation, Fixed=FixedRandomGenerator)


class Encoder(torch.nn.Module):
    """A tanh trunk, a mean head and a positive variance head."""

    def __init__(self, n_in, hidden, latent):
        super().__init__()
        self.Dense_0 = Dense(n_in, hidden)
        self.Dense_1 = Dense(hidden, latent)
        self.Dense_2 = Dense(hidden, latent)

    def forward(self, x):
        h = torch.tanh(self.Dense_0(x))
        return self.Dense_1(h), torch.exp(self.Dense_2(h)) + 1e-6


class FlaxEncoder(fnn.Module):
    hidden: int
    latent: int

    @fnn.compact
    def __call__(self, x):
        h = jnp.tanh(fnn.Dense(self.hidden)(x))
        return fnn.Dense(self.latent)(h), \
            jnp.exp(fnn.Dense(self.latent)(h)) + 1e-6


class SoftmaxEncoder(torch.nn.Module):
    def __init__(self, n_in, hidden, classes):
        super().__init__()
        self.Dense_0 = Dense(n_in, hidden)
        self.Dense_1 = Dense(hidden, classes)

    def forward(self, x):
        h = torch.tanh(self.Dense_0(x))
        return torch.softmax(self.Dense_1(h), dim=-1) + 1e-6


class FlaxSoftmaxEncoder(fnn.Module):
    hidden: int
    classes: int

    @fnn.compact
    def __call__(self, x):
        h = jnp.tanh(fnn.Dense(self.hidden)(x))
        return jax.nn.softmax(fnn.Dense(self.classes)(h)) + 1e-6


def lift(P, torch_module, flax_module, name, input_shapes, **kw):
    if P is J:
        return FlaxFunction(flax_module, name=name, input_shapes=input_shapes,
                            rng_key=jax.random.PRNGKey(1), dtype="float64",
                            **kw)
    return NNFunction(torch_module, name=name, input_shapes=input_shapes,
                      dtype="float64", device="cpu", **kw)


# ---------------------------------------------------------------------
# the models: (model, posterior, observed, data, S), alike in both
# packages
# ---------------------------------------------------------------------

def bnn(P, N=16, hidden=4):
    """config 5a (bnn_vae_dp.py:30-71) at N = 16, 2 → 4 → 4 → 1."""
    rng = np.random.default_rng(0)
    X = rng.random((N, 2)) * 2 - 1
    Y = np.sin(3 * X[:, :1]) + rng.standard_normal((N, 1)) * 0.05
    torch.manual_seed(0)
    widths = (2, hidden, hidden, 1)
    net = lift(P, MLP(widths), FlaxMLP(widths), "f", [(N, 2)])
    m = P.pkg.Model()
    m.x = P.pkg.Variable(shape=(N, 2))
    m.r = net(m.x)
    for _, v in m.r.factor.function.parameters.items():
        v.set_prior(P.dist.Normal(
            mean=P.ops.broadcast_to(P.pkg.Variable(value=0.), v.shape),
            variance=P.ops.broadcast_to(P.pkg.Variable(value=1.), v.shape)))
    m.noise = P.pkg.Variable(transformation=P.Positive(), initial_value=0.01)
    m.y = P.dist.Normal.define_variable(
        mean=m.r, variance=P.ops.broadcast_to(m.noise, (N, 1)),
        shape=(N, 1))
    meanfield = jinference.create_Gaussian_meanfield if P is J else \
        tinference.create_Gaussian_meanfield
    q = meanfield(model=m, observed=[m.x, m.y])
    return m, q, [m.x, m.y], {"x": X, "y": Y}, 4


def vae(P, N=16, D=6, K=2, hidden=8):
    """config 5b (bnn_vae_dp.py:74-123) at N = 16, D = 6, K = 2."""
    rng = np.random.default_rng(1)
    z_true = rng.standard_normal((N, K))
    x = np.tanh(z_true @ rng.standard_normal((K, D))) + \
        rng.standard_normal((N, D)) * 0.05
    torch.manual_seed(1)
    decoder = lift(P, MLP((K, hidden, D)), FlaxMLP((K, hidden, D)), "dec",
                   [(N, K)])
    m = P.pkg.Model()
    m.z = P.dist.Normal.define_variable(
        mean=P.ops.broadcast_to(P.pkg.Variable(value=0.), (N, K)),
        variance=P.ops.broadcast_to(P.pkg.Variable(value=1.), (N, K)),
        shape=(N, K))
    m.x_mean = decoder(m.z)
    m.x = P.dist.Normal.define_variable(
        mean=m.x_mean,
        variance=P.ops.broadcast_to(P.pkg.Variable(value=0.01), (N, D)),
        shape=(N, D))
    encoder = lift(P, Encoder(D, hidden, K), FlaxEncoder(hidden, K), "enc",
                   [(N, D)], num_outputs=2)
    q = P.pkg.Posterior(m)
    q_mean, q_var = encoder(q.x)
    q.z.set_prior(P.dist.Normal(mean=q_mean, variance=q_var))
    return m, q, [m.x], {"x": x}, 3


def concrete_vae(P, N=12, D=4, K=3, hidden=8):
    """The Concrete VAE of test_concrete.py:95-130 at N = 12."""
    rng = np.random.default_rng(2)
    centers = np.eye(K, D) * 2.0
    x = centers[rng.integers(0, K, N)] + rng.standard_normal((N, D)) * 0.15
    torch.manual_seed(2)
    decoder = lift(P, MLP((K, D)), FlaxMLP((K, D)), "dec", [(N, K)])
    m = P.pkg.Model()
    m.z = P.dist.Concrete.define_variable(
        probs=P.ops.broadcast_to(P.pkg.Variable(value=1.0 / K), (N, K)),
        shape=(N, K), temperature=0.5)
    m.x_mean = decoder(m.z)
    m.x = P.dist.Normal.define_variable(
        mean=m.x_mean,
        variance=P.ops.broadcast_to(P.pkg.Variable(value=0.05), (N, D)),
        shape=(N, D))
    encoder = lift(P, SoftmaxEncoder(D, hidden, K),
                   FlaxSoftmaxEncoder(hidden, K), "enc", [(N, D)])
    q = P.pkg.Posterior(m)
    q.z.set_prior(P.dist.Concrete(probs=encoder(q.x), temperature=0.5))
    return m, q, [m.x], {"x": x}, 4


def svi(P, build):
    with jax_f64():
        m, q, observed, data, S = build(P)
        inf = P.inf.GradBasedInference(
            P.inf.StochasticVariationalInference(
                num_samples=S, model=m, posterior=q, observed=observed),
            dtype="float64", **({} if P is J else {"device": "cpu"}))
        inf.initialize(**data)
    return inf, data


def fix_draws(P, inf):
    """Each posterior latent draws from a fixed buffer (uniforms for a
    Concrete latent, normals otherwise), seeded by its name path."""
    paths = name_paths(inf.graphs)
    q = inf.inference_algorithm.posterior
    S = inf.inference_algorithm.num_samples
    for v in q.variables.values():
        if v.type.name != "RANDVAR":
            continue
        rng = np.random.default_rng(zlib.crc32(paths[v.uuid].encode()))
        n = S * int(np.prod(v.shape))
        buf = rng.uniform(0.02, 0.98, n) \
            if type(v.factor).__name__ == "Concrete" \
            else rng.standard_normal(n)
        v.factor._rand_gen = P.Fixed(buf)


def neg_elbo(P, inf, data):
    fix_draws(P, inf)
    alg = inf.inference_algorithm
    args = (inf.params.trainable_params(), inf.params.fixed_params(),
            [data[v.name] for v in alg.observed_variables])
    if P is J:
        with jax_f64():
            return float(jinference.create_executor(alg, inf.params)(
                *args, jax.random.PRNGKey(0))[0])
    return float(tinference.create_executor(alg, inf.params)(
        *args, torch.Generator())[0].detach())


def moved(P, inf, seed):
    """Every parameter of ``inf`` moved by seeded draws (by name path)."""
    rng = np.random.default_rng(seed)
    state = {p: v + 0.1 * rng.standard_normal(v.shape)
             for p, v in by_path(inf.graphs, inf.params.param_dict).items()}
    if P is J:
        uuids = {p: u for u, p in name_paths(inf.graphs).items()}
        inf.params.update_params({uuids[p]: jnp.asarray(v)
                                  for p, v in state.items()})
    else:
        load_state(inf.params, state, inf.graphs)
    return state


MODELS = {"bnn": bnn, "vae": vae, "concrete_vae": concrete_vae}


@pytest.fixture(scope="module", params=list(MODELS))
def jax_case(request):
    """A JAX inference of each model, moved off its initial state, and
    its negative ELBO on the fixed draws."""
    build = MODELS[request.param]
    jinf, data = svi(J, build)
    state = moved(J, jinf, 3)
    return build, jinf, data, state, neg_elbo(J, jinf, data)


def test_negative_elbo_on_fixed_draws_matches_jax(jax_case):
    build, jinf, data, state, want = jax_case
    tinf, _ = svi(T, build)
    jpaths, tpaths = name_paths(jinf.graphs), name_paths(tinf.graphs)
    assert sorted(jpaths.values()) == sorted(tpaths.values())
    load_state(tinf.params, state, tinf.graphs)
    assert np.isfinite(want)
    np.testing.assert_allclose(neg_elbo(T, tinf, data), want, rtol=RTOL)


def test_bnn_weights_have_flax_paths():
    """Each weight is a latent with a mean-field factor; q's mean and
    variance go by the weight's path, its prior's by ``p(...)``."""
    tinf, _ = svi(T, bnn)
    paths = set(name_paths(tinf.graphs).values())
    for layer in range(3):
        for leaf in ("kernel", "bias"):
            w = "r.f_Dense_{}_{}".format(layer, leaf)
            assert {w, w + ".mean", w + ".variance", "p({}).mean".format(w),
                    "p({}).variance".format(w)} <= paths
    trained = {name_paths(tinf.graphs)[k] for k in tinf.params.param_dict}
    assert len(trained) == 2 * 6 + 1 and "noise" in trained


def test_bnn_svi_trains_and_samples_the_predictive():
    """A few SVI steps lower the loss; forward sampling of the trained
    posterior gives 100 draws of y."""
    tinf, data = svi(T, bnn)
    losses = []
    tinf.run(max_iter=30, learning_rate=0.05,
             generator=torch.Generator().manual_seed(0),
             callback=lambda i, l: losses.append(float(l)), **data)
    assert losses[-1] < losses[0]
    m = tinf.graphs[0]
    fwd = tinference.VariationalPosteriorForwardSampling(
        num_samples=100, observed=[m.x], inherited_inference=tinf,
        target_variables=[m.y])
    (samples,) = fwd.run(x=data["x"])
    assert tuple(samples.shape) == (100, 16, 1)
    assert torch.isfinite(samples).all()


# ---------------------------------------------------------------------
# the BNN's zips
# ---------------------------------------------------------------------

def test_bnn_zip_port_to_port(tmp_path):
    tinf, data = svi(T, bnn)
    moved(T, tinf, 5)
    want = neg_elbo(T, tinf, data)
    path = str(tmp_path / "bnn.zip")
    tinf.save(path)
    torch.manual_seed(7)     # a fresh network init and fresh UUIDs
    other, _ = svi(T, bnn)
    assert neg_elbo(T, other, data) != want
    other.load(path)
    np.testing.assert_allclose(neg_elbo(T, other, data), want, rtol=RTOL)


def test_bnn_zip_jax_to_port(tmp_path):
    jinf, data = svi(J, bnn)
    moved(J, jinf, 6)
    want = neg_elbo(J, jinf, data)
    path = str(tmp_path / "jax.zip")
    with jax_f64():
        jinf.save(path)
    tinf, _ = svi(T, bnn)
    tinf.load(path)
    np.testing.assert_allclose(neg_elbo(T, tinf, data), want, rtol=RTOL)


def test_bnn_zip_port_to_jax(tmp_path):
    tinf, data = svi(T, bnn)
    moved(T, tinf, 8)
    want = neg_elbo(T, tinf, data)
    path = str(tmp_path / "port.zip")
    tinf.save(path)
    jinf, _ = svi(J, bnn)
    with jax_f64():
        jinf.load(path)
    np.testing.assert_allclose(neg_elbo(J, jinf, data), want, rtol=RTOL)


def test_a_python_float_constant_keeps_its_float64_digits():
    """The likelihood's variance of 0.01 enters the float64 env as 0.01,
    not as float32's 0.0099999998 (the VAE's ELBO would part from JAX's
    by 2e-8)."""
    from mxfusion_tpu_torch.inference.inference_alg import as_runtime_tensor
    t = as_runtime_tensor(0.01, torch.float64, "cpu")
    assert t.dtype == torch.float64 and t.item() == 0.01
    assert as_runtime_tensor(0.01, torch.float32, "cpu").dtype == \
        torch.float32
    assert as_runtime_tensor(np.array([3]), torch.float64, "cpu").dtype == \
        torch.int64
