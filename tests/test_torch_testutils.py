"""``mxfusion_tpu_torch.util.testutils`` against the JAX package's
``util/testutils.py``, float64 on the CPU.

Every public name of JAX's module is in the port's. The array helpers
give the same arrays; ``make_basic_model`` and ``make_bnn_model`` give
the same graph (factor kinds, variable name paths and shapes);
``make_net`` with JAX's weights carried through ``linear_stack_map``
computes what JAX's does at 1e-10, and its own weights come from its
seed alone; the check helpers pass and fail on the same samples as
JAX's, tensors included."""
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import mxfusion_tpu as mj
from mxfusion_tpu.util import testutils as jtu

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.util import testutils as ttu
from mxfusion_tpu_torch.util.carryover import (apply_param_map,
                                               linear_stack_map, name_paths)

from tests.test_torch_nn_function import (_on_the_cpu, draw,  # noqa: F401
                                          env_of, initial, one_application)
from tests.test_torch_svgp_classification import jax_f64

PUBLIC = sorted(n for n, v in vars(jtu).items()
                if not n.startswith("_") and inspect.isfunction(v)
                and v.__module__ == jtu.__name__)


def test_every_public_name_is_ported():
    assert PUBLIC == ["check_sampling_bivariate", "check_sampling_univariate",
                      "make_basic_model", "make_bnn_model", "make_net",
                      "make_spd_matrix", "numpy_array_reshape",
                      "prepare_runtime_array", "sample_moment_check"]
    for name in PUBLIC:
        assert inspect.isfunction(getattr(ttu, name)), name
        jargs = list(inspect.signature(getattr(jtu, name)).parameters)
        targs = list(inspect.signature(getattr(ttu, name)).parameters)
        assert targs[:len(jargs)] == jargs, name


@pytest.mark.parametrize("shape,has_samples,n_dim", [
    ((3,), False, 3), ((2, 3), True, 4), ((1, 4, 2), True, 3)])
def test_array_helpers_give_the_same_arrays(shape, has_samples, n_dim):
    a = np.random.default_rng(1).standard_normal(shape)
    np.testing.assert_array_equal(ttu.numpy_array_reshape(a, has_samples,
                                                          n_dim),
                                  jtu.numpy_array_reshape(a, has_samples,
                                                          n_dim))
    t = ttu.prepare_runtime_array(a, has_samples, dtype="float64")
    j = jtu.prepare_runtime_array(a, has_samples, dtype=jnp.float64)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float64
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for dim, seed in ((3, None), (5, 2)):
        rng = [None if seed is None else np.random.default_rng(seed)
               for _ in range(2)]
        np.testing.assert_array_equal(ttu.make_spd_matrix(dim, rng[0]),
                                      jtu.make_spd_matrix(dim, rng[1]))


def graph_of(m):
    """(factor kinds in order, {name path: shape}) of a model."""
    paths = name_paths([m])
    kinds = [type(f).__name__ for f in m.ordered_factors]
    shapes = {}
    for uuid, path in paths.items():
        v = m[uuid]
        shapes[path] = tuple(s if isinstance(s, int) else "symbolic"
                             for s in v.shape)
    return kinds, shapes


def test_make_basic_model_gives_the_same_graph():
    assert graph_of(ttu.make_basic_model()) == \
        graph_of(jtu.make_basic_model())


def test_make_bnn_model_gives_the_same_graph():
    """Up to the networks' layouts: JAX's flax names map onto the torch
    net's by ``linear_stack_map``, and each kernel (in, out) is the
    weight (out, in)."""
    with jax_f64():
        jm = jtu.make_bnn_model(jtu.make_net(), (100, 2))
    net = ttu.make_net()
    tm = ttu.make_bnn_model(net, (100, 2))
    jkinds, jshapes = graph_of(jm)
    tkinds, tshapes = graph_of(tm)
    assert tkinds == jkinds

    mapping = linear_stack_map("f", net.module)
    carried = {}
    for path, shape in jshapes.items():
        for source, (target, transpose) in mapping.items():
            if re.search(r"(?<!\w){}(?!\w)".format(source), path):
                path = re.sub(r"(?<!\w){}(?!\w)".format(source), target,
                              path)
                if path == "r." + target and transpose:
                    shape = shape[::-1]
        carried[path] = shape
    assert carried == tshapes


def test_make_net_with_carried_weights_computes_as_jax():
    """JAX's ``make_net(seed=3)`` weights, carried onto the port's net:
    the two networks' outputs on 7 rows agree at 1e-10."""
    x = np.random.default_rng(4).standard_normal((1, 7, 2))
    with jax_f64():
        jnet = jtu.make_net(input_shape=(7, 2), hidden=8, out=1, seed=3)
        jvalues = initial(jnet)
        jm = one_application(mj, jnet, (7, 2))
        env = env_of(jnet, jvalues)
        env[jm.x.uuid] = jnp.asarray(x)
        want = np.asarray(draw(jm, env)[jm.y.uuid])
    tnet = ttu.make_net(input_shape=(7, 2), hidden=8, out=1, seed=3,
                        dtype="float64")
    tvalues = apply_param_map(jvalues, linear_stack_map("f", tnet.module))
    assert sorted(tvalues) == ["f_0_bias", "f_0_weight", "f_2_bias",
                               "f_2_weight"]
    tm = one_application(mt, tnet, (7, 2))
    env = env_of(tnet, tvalues)
    env[tm.x.uuid] = torch.as_tensor(x)
    got = draw(tm, env)[tm.y.uuid].detach().numpy()
    assert got.shape == want.shape == (1, 7, 1)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_make_net_weights_follow_the_seed_alone():
    """The same seed gives the same weights whatever the global torch
    state; another seed other weights, within nn.Linear's bounds."""
    torch.manual_seed(0)
    a = initial(ttu.make_net(seed=5))
    torch.manual_seed(1)
    torch.rand(10)
    b = initial(ttu.make_net(seed=5))
    c = initial(ttu.make_net(seed=6))
    assert list(a) == ["f_0_weight", "f_0_bias", "f_2_weight", "f_2_bias"]
    for n in a:
        np.testing.assert_array_equal(a[n], b[n])
        assert not np.array_equal(a[n], c[n])
    assert np.abs(a["f_0_weight"]).max() <= 2 ** -0.5
    assert np.abs(a["f_2_weight"]).max() <= 8 ** -0.5


@pytest.mark.parametrize("shift,scale", [(0.0, 1.0), (0.5, 1.0),
                                         (0.0, 1.6), (0.1, 1.0)])
def test_check_helpers_agree_with_jax(shift, scale):
    """On normal draws moved by ``shift`` and scaled by ``scale``, each
    check passes or fails as JAX's does, on numpy and on tensors."""
    rng = np.random.default_rng(7)
    z = rng.standard_normal((4000, 2)) * scale + shift
    cov = np.array([[1.0, 0.3], [0.3, 1.0]])
    zb = z @ np.linalg.cholesky(cov).T
    verdicts = []
    for samples in (z, torch.as_tensor(z)):
        got = (ttu.sample_moment_check(samples, 0.0, 1.0),
               ttu.check_sampling_univariate(samples[:, 0],
                                             stats.norm.cdf),
               ttu.check_sampling_bivariate(
                   samples @ (np.linalg.cholesky(cov).T if
                              isinstance(samples, np.ndarray) else
                              torch.as_tensor(np.linalg.cholesky(cov).T)),
                   [0.0, 0.0], cov))
        verdicts.append(got)
    want = (jtu.sample_moment_check(z, 0.0, 1.0),
            jtu.check_sampling_univariate(z[:, 0], stats.norm.cdf),
            jtu.check_sampling_bivariate(zb, [0.0, 0.0], cov))
    assert verdicts[0] == verdicts[1] == want
    # the unshifted draws pass every check, the moved ones fail one
    assert all(want) == (shift == 0.0 and scale == 1.0)
