"""The reductions, ``diag``, ``reshape`` and ``transpose``, ``Variable``'s
operator sugar and the runtime sample-axis helpers against the JAX
package, float64 on the CPU.

Each operator builds the same one-factor graph in both packages and
evaluates it on the same seeded numpy input, at sample sizes 1 and 3,
with positive and negative axes: rtol 1e-12. The sugar builds one
expression graph (reflected operands and ``__neg__`` included) in both
packages and evaluates it by ancestral sampling."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxfusion_tpu as mj
from mxfusion_tpu.components.functions import operators as jops
from mxfusion_tpu.components import variables as jvariables

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.components.functions import operators as tops
from mxfusion_tpu_torch.components import variables as tvariables

RTOL = 1e-12
J = SimpleNamespace(pkg=mj, ops=jops, asarray=jnp.asarray)
T = SimpleNamespace(pkg=mt, ops=tops, asarray=torch.as_tensor)


def apply(P, op, x, event, **kw):
    """``op`` of package P applied to a variable of shape ``event``,
    evaluated on ``x`` (with its sample axis)."""
    m = P.pkg.Model()
    m.x = P.pkg.Variable(shape=event)
    m.y = getattr(P.ops, op)(m.x, **kw)
    out = m.y.factor.eval({m.x.uuid: P.asarray(x)})
    return np.asarray(out[m.y.factor.output_names[0]])


def assert_op_matches(op, x, event, **kw):
    want = apply(J, op, x, event, **kw)
    got = apply(T, op, x, event, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    return got


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("op", ["sum", "mean", "prod"])
@pytest.mark.parametrize("axis", [None, 0, 1, -1, (0, 2), (-1, 0)])
def test_reductions_match_jax(op, axis, s):
    x = np.random.default_rng(0).uniform(0.5, 1.5, (s, 2, 3, 4))
    got = assert_op_matches(op, x, (2, 3, 4), axis=axis)
    assert got.shape[0] == s    # the sample axis is never reduced


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("k", [-1, 0, 2])
def test_diag_matches_jax(k, s):
    rng = np.random.default_rng(1)
    vec = rng.standard_normal((s, 4))
    got = assert_op_matches("diag", vec, (4,), k=k)
    assert got.shape == (s, 4 + abs(k), 4 + abs(k))
    mat = rng.standard_normal((s, 4, 5))
    assert_op_matches("diag", mat, (4, 5), k=k)


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("shape", [(6, 4), (4, -1), (24,)])
def test_reshape_keeps_the_sample_axis(shape, s):
    x = np.random.default_rng(2).standard_normal((s, 2, 3, 4))
    got = assert_op_matches("reshape", x, (2, 3, 4), shape=shape)
    assert got.shape[0] == s


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("axes", [None, (1, 0, 2), (-1, 0, 1), (2, 1, 0)])
def test_transpose_matches_jax(axes, s):
    x = np.random.default_rng(3).standard_normal((s, 2, 3, 4))
    got = assert_op_matches("transpose", x, (2, 3, 4), axes=axes)
    assert got.shape[0] == s


def test_exports_match_jax():
    """Every public name of the JAX package's operators and variables
    modules is exported by the port's; ``FlaxFunction``'s counterpart is
    ``NNFunction``."""
    from mxfusion_tpu.components import functions as jfunctions
    from mxfusion_tpu_torch.components import functions as tfunctions
    for jmod, tmod in ((jops, tops), (jvariables, tvariables)):
        names = [n for n in dir(jmod) if not n.startswith("_")
                 and callable(getattr(jmod, n))]
        assert "transpose" in names or "get_num_samples" in names
        missing = [n for n in names if not hasattr(tmod, n)]
        assert not missing, missing
    for name in ("sum", "mean", "prod", "diag", "reshape", "transpose"):
        assert getattr(tfunctions.operators, name) is getattr(tops, name)
    names = {n for n in dir(jfunctions) if not n.startswith("_")
             and isinstance(getattr(jfunctions, n), type)}
    assert names - {n for n in dir(tfunctions)} == {"FlaxFunction"}
    assert isinstance(tfunctions.NNFunction, type)


# ---------------------------------------------------------------------
# the operator sugar
# ---------------------------------------------------------------------

def sugar(P, x, y):
    """One expression of every overloaded operator, forward and
    reflected, evaluated by ancestral sampling on x, y."""
    m = P.pkg.Model()
    m.x = P.pkg.Variable(shape=(2, 3))
    m.y = P.pkg.Variable(shape=(2, 3))
    m.z = (m.x + m.y) * 2.0 - m.y / m.x + 1.5 * m.x - (0.5 - m.y) \
        + (-m.x) + 3.0 / m.y + m.x ** 2.0 + 1.2 ** m.y + (2.0 + m.x) \
        + m.x * m.y - m.y - 4.0
    env = {m.x.uuid: P.asarray(x), m.y.uuid: P.asarray(y)}
    for v in m.get_constants():
        env[v.uuid] = P.asarray(np.asarray(float(v.constant))[None])
    n_factors = len(m.ordered_factors)
    if P is J:
        out = m.draw_samples(env, None)
    else:
        out = m.draw_samples(env, torch.Generator())
    return np.asarray(out[m.z.uuid]), n_factors


@pytest.mark.parametrize("s", [1, 3])
def test_variable_sugar_builds_the_jax_graph(s):
    rng = np.random.default_rng(4)
    x = rng.uniform(0.5, 1.5, (s, 2, 3))
    y = rng.uniform(0.5, 1.5, (s, 2, 3))
    want, jn = sugar(J, x, y)
    got, tn = sugar(T, x, y)
    assert tn == jn
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    direct = (x + y) * 2.0 - y / x + 1.5 * x - (0.5 - y) - x + 3.0 / y \
        + x ** 2.0 + 1.2 ** y + (2.0 + x) + x * y - y - 4.0
    np.testing.assert_allclose(got, direct, rtol=RTOL)


def test_negation_is_multiply_by_minus_one():
    for P in (J, T):
        m = P.pkg.Model()
        m.x = P.pkg.Variable(shape=(2,))
        m.y = -m.x
        assert m.y.factor.operator_name == "multiply"
        assert float(m.y.factor.inputs[1][1].constant) == -1.0


# ---------------------------------------------------------------------
# the runtime helpers
# ---------------------------------------------------------------------

def test_runtime_helpers_match_jax():
    x = np.random.default_rng(5).standard_normal((2, 3))
    for P, V in ((J, jvariables), (T, tvariables)):
        a = V.add_sample_dimension(P.asarray(x))
        assert tuple(a.shape) == (1, 2, 3)
        assert not V.array_has_samples(a)
        assert V.get_num_samples(a) == 1
        b = P.asarray(np.stack([x, x, x]))
        assert V.array_has_samples(b) and V.get_num_samples(b) == 3
    arrays = {"a": x, "t": torch.as_tensor(x), "n": 7}
    out = tvariables.add_sample_dimension_to_arrays(arrays)
    jout = jvariables.add_sample_dimension_to_arrays(
        {"a": x, "t": x, "n": 7})
    assert out["n"] == jout["n"] == 7
    for k in ("a", "t"):
        assert isinstance(out[k], torch.Tensor)
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    target = {}
    assert tvariables.add_sample_dimension_to_arrays(
        {"a": x}, out=target) is target and target["a"].shape == (1, 2, 3)
