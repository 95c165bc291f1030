"""PILCO against the JAX package, and on its own.

The GP dynamics are fitted by JAX's MAP and carried into the port by
name path (the kernel's hyperparameters, the noise variance and the
posterior cache (X, L, L⁻¹Y) that the rollout's predictions read). At
that state, ``PILCOAlgorithm.compute``'s trajectory cost and its
gradient in the policy weight agree with JAX's at rtol 1e-10, on the
1-D system of ``tests/inference/test_pilco.py`` and on a 4-state,
1-action linear system (N = 32, 3 steps, Y of shape (N, 4)). A short run
of the port alone lowers the cost and learns a damping gain."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxfusion_tpu as mj
from mxfusion_tpu import inference as jinf
from mxfusion_tpu.components.distributions.gp.kernels import RBF as JRBF
from mxfusion_tpu.components.variables import \
    PositiveTransformation as JPositive
from mxfusion_tpu.inference import inference_alg as jalg
from mxfusion_tpu.inference import pilco_alg as jpilco
from mxfusion_tpu.modules import GPRegression as JGPRegression

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch import inference as tinf
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import inference_alg as talg
from mxfusion_tpu_torch.inference import pilco_alg as tpilco
from mxfusion_tpu_torch.modules import GPRegression
from mxfusion_tpu_torch.util.carryover import load_state
from tests.test_torch_kalman import close
from tests.test_torch_meanfield import _on_the_cpu_in_float64  # noqa: F401
from tests.test_torch_svgp_classification import jax_f64

J = SimpleNamespace(pkg=mj, inf=jinf, alg=jalg, RBF=JRBF,
                    Positive=JPositive, GPRegression=JGPRegression, np=jnp,
                    einsum=jnp.einsum)
T = SimpleNamespace(pkg=mt, inf=tinf, alg=talg, RBF=RBF,
                    Positive=PositiveTransformation,
                    GPRegression=GPRegression, np=torch,
                    einsum=torch.einsum)


@pytest.fixture(autouse=True, scope="module")
def _jax_in_float64():
    with jax_f64():
        yield


def one_d(n=60):
    """test_pilco.py's transitions: s' = 0.8 s + 0.5 a, random actions."""
    rng = np.random.default_rng(0)
    S = rng.standard_normal((n, 1))
    A = rng.uniform(-1, 1, (n, 1))
    S_next = 0.8 * S + 0.5 * A + rng.standard_normal((n, 1)) * 0.01
    return np.concatenate([S, A], -1), S_next


def four_state(n=32):
    """A damped 4-state, 1-action linear system s' = F s + g a."""
    rng = np.random.default_rng(1)
    F = np.eye(4) * 0.9 + 0.05 * rng.standard_normal((4, 4))
    g = rng.standard_normal((4, 1)) * 0.5
    S = rng.standard_normal((n, 4))
    A = rng.uniform(-1, 1, (n, 1))
    S_next = S @ F.T + A @ g.T + rng.standard_normal((n, 4)) * 0.01
    return np.concatenate([S, A], -1), S_next


SYSTEMS = {"1d": (one_d, 8, 4, [[-0.2]]),
           "4state": (four_state, 3, 4,
                      [[0.1], [-0.2], [0.05], [0.3]])}


def dynamics(P, X, Y):
    """GPRegression over the state-action inputs, as the JAX test's."""
    m = P.pkg.Model()
    m.N = P.pkg.Variable()
    m.X = P.pkg.Variable(shape=(m.N, X.shape[1]))
    m.noise_var = P.pkg.Variable(transformation=P.Positive(),
                                 initial_value=0.01)
    m.Y = P.GPRegression.define_variable(
        X=m.X, kernel=P.RBF(input_dim=X.shape[1], variance=1.,
                            lengthscale=1.),
        noise_var=m.noise_var, shape=(m.N, Y.shape[1]))
    return m


def pilco(P, m, dyn_params, w0, n_steps, num_samples, s0):
    """A linear policy a = s·w with w trainable, the cost Σ s², and the
    PILCO inference carried over from the dynamics fit."""
    m.policy_w = P.pkg.Variable(shape=np.shape(w0),
                                initial_value=np.asarray(w0))

    def policy(s, env):
        return P.einsum("...i,ij->...j", s, env[m.policy_w.uuid][0])

    def cost(s, a, env):
        return P.np.sum(P.np.square(s))

    def initial_states(k):
        return jnp.asarray(s0[:k]) if P is J else torch.as_tensor(s0[:k])

    alg = P.inf.PILCOAlgorithm(
        model=m, observed=[], cost_function=cost, policy=policy,
        n_time_steps=n_steps, initial_state_generator=initial_states,
        num_samples=num_samples)
    kw = {"device": "cpu"} if P is T else {}
    return P.inf.GradTransferInference(inference_algorithm=alg,
                                       infr_params=dyn_params, **kw)


@pytest.fixture(scope="module", params=sorted(SYSTEMS))
def carried(request):
    """JAX's dynamics after 30 MAP steps, the port's at the same state."""
    make, n_steps, k, w0 = SYSTEMS[request.param]
    X, Y = make()
    jm = dynamics(J, X, Y)
    jdyn = J.inf.GradBasedInference(J.inf.MAP(model=jm, observed=[jm.X,
                                                                  jm.Y]))
    jdyn.run(max_iter=30, learning_rate=0.05, X=X, Y=Y)
    tm = dynamics(T, X, Y)
    tdyn = T.inf.GradBasedInference(T.inf.MAP(model=tm, observed=[tm.X,
                                                                  tm.Y]),
                                    device="cpu")
    tdyn.initialize(X=X, Y=Y)
    load_state(tdyn.params, {u: np.asarray(v) for u, v in
                             jdyn.params.param_dict.items()},
               tdyn.graphs, source_graphs=jdyn.graphs)
    s0 = np.random.default_rng(2).standard_normal((k, X.shape[1] - 1))
    return (jm, jdyn), (tm, tdyn), (n_steps, k, w0, s0)


def test_rollout_cost_and_policy_gradient_match_jax(carried):
    (jm, jdyn), (tm, tdyn), (n_steps, k, w0, s0) = carried
    ji = pilco(J, jm, jdyn.params, w0, n_steps, k, s0)
    ti = pilco(T, tm, tdyn.params, w0, n_steps, k, s0)
    ji.initialize()
    ti.initialize()
    # the policy weight moved off its start in JAX, and JAX's whole state
    # (policy weight, GP dynamics, posterior cache) carried by name path
    jw = ji.params.param_dict[jm.policy_w.uuid]
    ji.params.update_params({jm.policy_w.uuid: jw + 0.1})
    load_state(ti.params, {u: np.asarray(v) for u, v in
                           ji.params.param_dict.items()},
               ti.graphs, source_graphs=ji.graphs)
    close(ti.params[tm.policy_w], np.asarray(w0) + 0.1)
    jex = J.alg.create_executor(ji.inference_algorithm, ji.params)
    tex = T.alg.create_executor(ti.inference_algorithm, ti.params)
    jfixed = ji.params.fixed_params()

    def jax_cost(w):
        tr = dict(ji.params.trainable_params(), **{jm.policy_w.uuid: w})
        return jex(tr, jfixed, [], jax.random.PRNGKey(0))[0]

    jw = ji.params.param_dict[jm.policy_w.uuid]
    ref, ref_g = jax_cost(jw), jax.grad(jax_cost)(jw)
    tr = {u: v.detach().clone().requires_grad_(u == tm.policy_w.uuid)
          for u, v in ti.params.trainable_params().items()}
    cost = tex(tr, ti.params.fixed_params(), [],
               torch.Generator().manual_seed(0))[0]
    g, = torch.autograd.grad(cost, [tr[tm.policy_w.uuid]])
    assert tuple(cost.shape) == () and np.isfinite(float(cost.detach()))
    close(cost, ref)
    close(g, ref_g)


def test_rollout_writes_the_inputs_into_the_env(carried):
    """Each step's state-action inputs are the env's own X (the module
    reads them there): after a rollout, env[X] holds the last step's
    inputs, (num_samples, 1, state + action)."""
    _, (tm, tdyn), (n_steps, k, w0, s0) = carried
    ti = pilco(T, tm, tdyn.params, w0, n_steps, k, s0)
    ti.initialize()
    env = T.alg.create_executor(ti.inference_algorithm,
                                ti.params).build_env(
        ti.params.trainable_params(), ti.params.fixed_params(), [])
    assert isinstance(env, T.alg.VariableEnv)
    ti.inference_algorithm.compute(env, T.alg.RuntimeContext(
        torch.Generator()))
    assert tuple(env[tm.X].shape) == (k, 1, s0.shape[1] + 1)


def test_call_flex_with_and_without_env():
    env = {"w": 2.0}

    def with_env(s, env):
        return s * env["w"]

    def without_env(s):
        return s + 1.0

    for flex in (jpilco._call_flex, tpilco._call_flex):
        assert flex(with_env, 3.0, env=env) == 6.0
        assert flex(without_env, 3.0, env=env) == 4.0
        assert flex(without_env, 3.0) == 4.0
        # a callable without a signature is called with its args alone
        assert flex(abs, -3.0, env=env) == 3.0
        with pytest.raises(TypeError):
            flex(with_env, 3.0)


def test_policy_learns_a_damping_gain():
    """test_pilco_policy_improves on the port alone (shorter): the cost
    falls and the learned gain is negative."""
    X, Y = one_d()
    m = dynamics(T, X, Y)
    dyn = T.inf.GradBasedInference(T.inf.MAP(model=m, observed=[m.X, m.Y]),
                                   device="cpu")
    dyn.run(max_iter=60, learning_rate=0.05, X=X, Y=Y)
    infr = pilco(T, m, dyn.params, [[0.0]], 8, 4, np.ones((4, 1)))
    losses = []
    infr.run(max_iter=25, learning_rate=0.1,
             callback=lambda i, l: losses.append(float(l)))
    assert losses[-1] < losses[0]
    assert float(infr.params[m.policy_w].reshape(-1)[0]) < 0.0
