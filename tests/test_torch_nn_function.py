"""``NNFunction`` (a ``torch.nn.Module`` lifted into the model IR)
against the JAX package's ``FlaxFunction``, float64 on the CPU: the
cases of ``tests/components/test_functions.py``.

The torch networks here are laid out as flax's (sub-modules ``Dense_0``,
``Dense_1``, ... with a ``kernel`` of shape (in, out) and a ``bias``), so
their lifted parameters carry flax's names and both packages evaluate
the same weights: each test gives both graphs the same values by name.
The nets are shared with the other ``test_torch_*`` files of the slice.
"""
import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

import mxfusion_tpu as mj
from mxfusion_tpu.components.functions import FlaxFunction

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.common.exceptions import ModelSpecificationError
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions import Function, NNFunction
from mxfusion_tpu_torch.components.functions.operators import broadcast_to

RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port runs on the card unless the CPU is asked for: these tests
    ask for it, and put the previous default back afterwards."""
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


# ---------------------------------------------------------------------
# flax-layout torch networks and their flax twins
# ---------------------------------------------------------------------

class Dense(torch.nn.Module):
    """flax's ``nn.Dense``: ``x @ kernel + bias``, kernel (in, out)."""

    def __init__(self, n_in, n_out, dtype=torch.float64):
        super().__init__()
        self.kernel = torch.nn.Parameter(
            torch.randn(n_in, n_out, dtype=dtype) / np.sqrt(n_in))
        self.bias = torch.nn.Parameter(0.1 * torch.randn(n_out, dtype=dtype))

    def forward(self, x):
        return x @ self.kernel + self.bias


class MLP(torch.nn.Module):
    """Dense layers of ``widths`` with tanh between them."""

    def __init__(self, widths, dtype=torch.float64):
        super().__init__()
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            setattr(self, "Dense_{}".format(i), Dense(a, b, dtype))
        self.n_layers = len(widths) - 1

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, "Dense_{}".format(i))(x)
            if i < self.n_layers - 1:
                x = torch.tanh(x)
        return x


class FlaxMLP(fnn.Module):
    widths: tuple

    @fnn.compact
    def __call__(self, x):
        for i, w in enumerate(self.widths[1:]):
            x = fnn.Dense(w)(x)
            if i < len(self.widths) - 2:
                x = jnp.tanh(x)
        return x


class TwoHead(torch.nn.Module):
    """A tanh trunk and two linear heads (flax's call order)."""

    def __init__(self, n_in, hidden, outs):
        super().__init__()
        self.Dense_0 = Dense(n_in, hidden)
        self.Dense_1 = Dense(hidden, outs[0])
        self.Dense_2 = Dense(hidden, outs[1])

    def forward(self, x):
        h = torch.tanh(self.Dense_0(x))
        return self.Dense_1(h), self.Dense_2(h)


class FlaxTwoHead(fnn.Module):
    hidden: int
    outs: tuple

    @fnn.compact
    def __call__(self, x):
        h = jnp.tanh(fnn.Dense(self.hidden)(x))
        return fnn.Dense(self.outs[0])(h), fnn.Dense(self.outs[1])(h)


def flax_function(module, name, input_shapes, **kw):
    return FlaxFunction(module, name=name, input_shapes=input_shapes,
                        rng_key=jax.random.PRNGKey(0), dtype="float64", **kw)


def env_of(net, values):
    """``{uuid: array}`` of ``net``'s parameters from ``values`` (by lifted
    name), given a sample axis of 1 where they have none, for either
    package."""
    as_array = jnp.asarray if isinstance(net, FlaxFunction) else \
        torch.as_tensor
    return {v.uuid: as_array(values[n][None] if values[n].ndim ==
                             len(v.shape) else values[n])
            for n, v in net.parameters.items()}


def initial(net):
    return {n: np.asarray(v.initial_value, dtype=np.float64)
            for n, v in net.parameters.items()}


def one_application(P, net, shape):
    m = P.Model()
    m.x = P.Variable(shape=shape)
    m.y = net(m.x)
    return m


def draw(m, env):
    """Ancestral evaluation of either package's model."""
    if isinstance(m, mj.Model):
        return m.draw_samples(env, jax.random.PRNGKey(0))
    return m.draw_samples(env, torch.Generator())


# ---------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------

def test_parameters_are_lifted_with_flax_names():
    torch.manual_seed(0)
    tnet = NNFunction(MLP((2, 8, 1)), name="f", input_shapes=[(5, 2)],
                      dtype="float64")
    jnet = flax_function(FlaxMLP((2, 8, 1)), "f", [(5, 2)])
    assert sorted(tnet.parameters) == sorted(jnet.parameters) == [
        "f_Dense_0_bias", "f_Dense_0_kernel", "f_Dense_1_bias",
        "f_Dense_1_kernel"]
    # registration order, not flax's sorted order
    assert list(tnet.parameters) == ["f_Dense_0_kernel", "f_Dense_0_bias",
                                     "f_Dense_1_kernel", "f_Dense_1_bias"]
    for n, v in tnet.parameters.items():
        assert v.isInherited and v.initial_value is not None
        assert tuple(v.shape) == tuple(jnet.parameters[n].shape)
    assert tnet.input_names == jnet.input_names == ["f_input_0"]
    assert tnet.output_names == jnet.output_names == ["f_output_0"]

    # an nn.Sequential's names follow its paths
    seq = torch.nn.Sequential(torch.nn.Linear(2, 4), torch.nn.Tanh(),
                              torch.nn.Linear(4, 1))
    assert list(NNFunction(seq, name="g", input_shapes=[(3, 2)]).parameters) \
        == ["g_0_weight", "g_0_bias", "g_2_weight", "g_2_bias"]


def test_lifted_network_evaluates_as_flax():
    torch.manual_seed(1)
    x = np.random.default_rng(0).standard_normal((1, 5, 2))
    tnet = NNFunction(MLP((2, 8, 1)), name="f", input_shapes=[(5, 2)],
                      dtype="float64")
    values = initial(tnet)
    outs = []
    for P, net in ((mj, flax_function(FlaxMLP((2, 8, 1)), "f", [(5, 2)])),
                   (mt, tnet)):
        m = one_application(P, net, (5, 2))
        env = env_of(net, values)
        env[m.x.uuid] = (jnp.asarray if P is mj else torch.as_tensor)(x)
        outs.append(np.asarray(draw(m, env)[m.y.uuid]))
    assert outs[1].shape == (1, 5, 1)
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL)
    direct = tnet.module(torch.as_tensor(x[0])).detach().numpy()
    np.testing.assert_allclose(outs[1][0], direct, rtol=RTOL)


def test_non_broadcastable_function_vmaps_over_samples():
    """A plain function and a network whose weights carry 3 samples:
    mapped over the sample axis, as JAX maps them."""
    f = Function(lambda x: torch.cumsum(x, dim=-1), input_names=["x"],
                 output_names=["out"], broadcastable=False)
    m = mt.Model()
    m.x = Normal.define_variable(mean=0., variance=1., shape=(4,))
    m.z = f(m.x)
    env = {v.uuid: torch.as_tensor(float(v.constant),
                                   dtype=torch.float64)[None]
           for v in m.get_constants()}
    samples = m.draw_samples(env, torch.Generator().manual_seed(0),
                             num_samples=6)
    x, z = samples[m.x.uuid], samples[m.z.uuid]
    assert z.shape == (6, 4)
    np.testing.assert_allclose(z, torch.cumsum(x, dim=-1), rtol=RTOL)

    torch.manual_seed(2)
    tnet = NNFunction(MLP((2, 4, 1)), name="f", input_shapes=[(5, 2)],
                      dtype="float64")
    rng = np.random.default_rng(1)
    values = {n: rng.standard_normal((3,) + tuple(v.shape))
              for n, v in tnet.parameters.items()}
    x = rng.standard_normal((1, 5, 2))
    outs = []
    for P, net in ((mj, flax_function(FlaxMLP((2, 4, 1)), "f", [(5, 2)])),
                   (mt, tnet)):
        m = one_application(P, net, (5, 2))
        env = env_of(net, values)
        env[m.x.uuid] = (jnp.asarray if P is mj else torch.as_tensor)(x)
        outs.append(np.asarray(draw(m, env)[m.y.uuid]))
    assert outs[1].shape == (3, 5, 1)
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL)


def test_random_parameters_force_the_vmap():
    """``broadcastable`` holds while the weights are parameters and is
    forced off once they carry priors, in both packages."""
    from mxfusion_tpu.components.distributions import Normal as JNormal
    from mxfusion_tpu.components.functions.operators import \
        broadcast_to as jbroadcast_to
    for P, dist, bcast, net in (
            (mj, JNormal, jbroadcast_to,
             flax_function(FlaxMLP((2, 3, 1)), "f", [(4, 2)],
                           broadcastable=True)),
            (mt, Normal, broadcast_to,
             NNFunction(MLP((2, 3, 1)), name="f", input_shapes=[(4, 2)],
                        broadcastable=True))):
        assert one_application(P, net, (4, 2)).y.factor.broadcastable
        for v in net.parameters.values():
            v.set_prior(dist(mean=bcast(P.Variable(value=0.), v.shape),
                             variance=bcast(P.Variable(value=1.), v.shape)))
        assert not one_application(P, net, (4, 2)).y.factor.broadcastable


def test_multiple_outputs_and_the_arity_error():
    torch.manual_seed(3)
    tnet = NNFunction(TwoHead(3, 4, (1, 2)), name="g",
                      input_shapes=[(5, 3)], num_outputs=2, dtype="float64")
    values = initial(tnet)
    x = np.ones((1, 5, 3))
    outs = []
    for P, net in ((mj, flax_function(FlaxTwoHead(4, (1, 2)), "g", [(5, 3)],
                                      num_outputs=2)), (mt, tnet)):
        m = P.Model()
        m.x = P.Variable(shape=(5, 3))
        m.a, m.b = net(m.x)
        env = env_of(net, values)
        env[m.x.uuid] = (jnp.asarray if P is mj else torch.as_tensor)(x)
        out = draw(m, env)
        outs.append((np.asarray(out[m.a.uuid]), np.asarray(out[m.b.uuid])))
    assert outs[1][0].shape == (1, 5, 1) and outs[1][1].shape == (1, 5, 2)
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, rtol=RTOL)

    one = NNFunction(TwoHead(3, 4, (1, 2)), name="g", input_shapes=[(5, 3)],
                     num_outputs=1, dtype="float64")
    m = mt.Model()
    m.x = mt.Variable(shape=(5, 3))
    m.a = one(m.x)
    env = env_of(one, initial(one))
    env[m.x.uuid] = torch.ones((1, 5, 3), dtype=torch.float64)
    with pytest.raises(ModelSpecificationError, match="num_outputs"):
        m.draw_samples(env, torch.Generator())


def test_weight_sharing_across_two_applications():
    torch.manual_seed(4)
    net = NNFunction(MLP((2, 3, 1)), name="f", input_shapes=[(4, 2)],
                     dtype="float64")
    m = mt.Model()
    m.x1 = mt.Variable(shape=(4, 2))
    m.x2 = mt.Variable(shape=(4, 2))
    m.y1 = net(m.x1)
    m.y2 = net(m.x2)
    uuids = {v.uuid for v in net.parameters.values()}
    p1 = {v.uuid for _, v in m.y1.factor.inputs if v.uuid in uuids}
    p2 = {v.uuid for _, v in m.y2.factor.inputs if v.uuid in uuids}
    assert p1 == p2 and len(p1) == len(net.parameters) == 4
    x = torch.as_tensor(np.random.default_rng(0).random((1, 4, 2)))
    env = env_of(net, initial(net))
    env.update({m.x1.uuid: x, m.x2.uuid: x})
    out = m.draw_samples(env, torch.Generator())
    torch.testing.assert_close(out[m.y1.uuid], out[m.y2.uuid], rtol=0,
                               atol=0)


class DenseNorm(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(2, 3)
        self.BatchNorm_0 = torch.nn.BatchNorm1d(3, dtype=torch.float64)

    def forward(self, x):
        return self.BatchNorm_0(self.Dense_0(x))


class FlaxDenseNorm(fnn.Module):
    train: bool = False

    @fnn.compact
    def __call__(self, x):
        return fnn.BatchNorm(use_running_average=not self.train)(
            fnn.Dense(3)(x))


def test_buffers_ride_along_read_only_in_eval_mode():
    """BatchNorm's running statistics are read, not lifted, and give
    flax's batch_stats function (mean 0, variance 1, eps 1e-5)."""
    torch.manual_seed(5)
    module = DenseNorm().eval()
    module.BatchNorm_0.running_mean.fill_(0.3)
    module.BatchNorm_0.running_var.fill_(2.0)
    tnet = NNFunction(module, name="bn", input_shapes=[(6, 2)],
                      dtype="float64")
    assert sorted(tnet.parameters) == [
        "bn_BatchNorm_0_bias", "bn_BatchNorm_0_weight", "bn_Dense_0_bias",
        "bn_Dense_0_kernel"]
    assert not any("running" in n or "batches" in n for n in tnet.parameters)
    jnet = flax_function(FlaxDenseNorm(train=False), "bn", [(6, 2)])
    assert "batch_stats" in jnet._extra_collections
    jnet._extra_collections = {"batch_stats": {"BatchNorm_0": {
        "mean": jnp.full((3,), 0.3), "var": jnp.full((3,), 2.0)}}}
    values = initial(tnet)
    values["bn_BatchNorm_0_scale"] = values["bn_BatchNorm_0_weight"]
    x = np.random.default_rng(2).standard_normal((1, 6, 2))
    outs = []
    for P, net in ((mj, jnet), (mt, tnet)):
        m = one_application(P, net, (6, 2))
        env = env_of(net, values)
        env[m.x.uuid] = (jnp.asarray if P is mj else torch.as_tensor)(x)
        outs.append(np.asarray(draw(m, env)[m.y.uuid]))
    assert outs[1].shape == (1, 6, 3)
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL)
    # the module's own buffers are untouched by evaluation
    assert torch.all(module.BatchNorm_0.running_mean == 0.3)
    assert int(module.BatchNorm_0.num_batches_tracked) == 0


def test_a_module_that_mutates_its_buffers_is_rejected():
    with pytest.raises(ModelSpecificationError, match="mutate"):
        NNFunction(DenseNorm().train(), name="bn", input_shapes=[(6, 2)],
                   dtype="float64")
    with pytest.raises(Exception, match="mutate"):
        flax_function(FlaxDenseNorm(train=True), "bn", [(6, 2)])


def test_nn_function_is_exported():
    from mxfusion_tpu_torch.components import functions
    assert functions.NNFunction is NNFunction
