"""``mxfusion_tpu_torch.parallel`` over four gloo processes on the CPU.

The cases of ``tests/parallel/test_data_parallel.py``,
``test_dp_minibatch.py``, ``test_mesh_helpers.py``,
``test_sharded_mcmc.py`` and ``test_multihost.py``, of the device loop's
sharded cases (``tests/inference/test_device_loop.py``) and of mesh
serving. One process group of four ranks, joined through
``parallel.initialize_distributed`` (the multi-host path), runs every
case once for the whole module (a module-scoped fixture: each process
pays one torch import) and hands back, per rank, the data-parallel
result beside the same computation in one process; each test compares
them, and the deterministic objective with the JAX package's. float64
throughout.
"""
import os
import pickle
import socket
import subprocess
import sys
import traceback
import warnings

import numpy as np
import pytest

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# =====================================================================
# the worker side: no JAX here, every rank runs every case
# =====================================================================

def _port():
    """The port's names the cases use, imported in the workers only."""
    from mxfusion_tpu_torch import Model, Variable, inference, modules
    from mxfusion_tpu_torch.components.distributions import Normal
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.components.functions.operators import (
        broadcast_to, dot)
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    return dict(Model=Model, Variable=Variable, inference=inference,
                modules=modules, Normal=Normal, RBF=RBF,
                broadcast_to=broadcast_to, dot=dot,
                PositiveTransformation=PositiveTransformation)


def _np(t):
    import torch
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _gen(seed=0):
    import torch
    return torch.Generator().manual_seed(seed)


def _normal_model(P, n=None, map_mu=False):
    m = P["Model"]()
    m.n = P["Variable"]()
    rows = m.n if n is None else n
    if map_mu:
        m.mu = P["Variable"](initial_value=0.5)
    else:
        m.mu = P["Normal"].define_variable(mean=0., variance=100.,
                                           shape=(1,))
    m.s = P["Variable"](transformation=P["PositiveTransformation"](),
                        initial_value=5.)
    m.y = P["Normal"].define_variable(
        mean=P["broadcast_to"](m.mu, (rows, 1)),
        variance=P["broadcast_to"](m.s, (rows, 1)), shape=(rows, 1))
    return m


def _svi(P, m, S=6):
    inf = P["inference"]
    q = inf.create_Gaussian_meanfield(model=m, observed=[m.y])
    return q, inf.StochasticVariationalInference(
        num_samples=S, model=m, posterior=q, observed=[m.y])


def _svgp(P, Z0):
    m = P["Model"]()
    m.n = P["Variable"]()
    m.X = P["Variable"](shape=(m.n, Z0.shape[1]))
    m.noise_var = P["Variable"](
        transformation=P["PositiveTransformation"](), initial_value=0.1)
    m.Y = P["modules"].SVGPRegression.define_variable(
        X=m.X, kernel=P["RBF"](input_dim=Z0.shape[1], variance=1.0,
                               lengthscale=1.0, dtype="float64"),
        noise_var=m.noise_var, shape=(m.n, 1), dtype="float64",
        inducing_inputs=P["Variable"](shape=Z0.shape, initial_value=Z0))
    return m


def _exact_gp(P):
    m = P["Model"]()
    m.N = P["Variable"]()
    m.X = P["Variable"](shape=(m.N, 1))
    m.noise_var = P["Variable"](
        transformation=P["PositiveTransformation"](), initial_value=0.1)
    m.Y = P["modules"].GPRegression.define_variable(
        X=m.X, kernel=P["RBF"](input_dim=1, variance=1.0, lengthscale=1.0,
                               dtype="float64"),
        noise_var=m.noise_var, shape=(m.N, 1), dtype="float64")
    return m


def _gp_data(seed, N=160):
    rng = np.random.default_rng(seed)
    X = rng.random((N, 1)) * 4
    return X, np.sin(X) + rng.standard_normal((N, 1)) * 0.1


def _train(P, m, alg, loop, steps, lr, data, **kw):
    inf = P["inference"].GradBasedInference(
        inference_algorithm=alg, grad_loop=loop, dtype="float64")
    losses = []
    inf.run(max_iter=steps, learning_rate=lr, generator=_gen(0),
            callback=lambda i, l: losses.append(float(l)), **data, **kw)
    return inf, np.asarray(losses)


def _by_name(inf, values):
    """``values`` ({uuid: tensor}) as a list in the order of their name
    paths, which two builds of one model share (their uuids differ)."""
    from mxfusion_tpu_torch.util.carryover import name_paths
    paths = name_paths(inf.graphs)
    return [_np(v) for _, v in sorted((paths[k], v)
                                      for k, v in values.items())]


def _state(inf):
    return _by_name(inf, inf.params.param_dict)


def _loss_factory(inf_mod):
    """``DataParallelPlan``'s factory for a loss objective."""
    return lambda alg, params, rv_scaling, _: inf_mod.create_executor(
        alg, params, rv_scaling)


def case_objective(P, mesh):
    """MAP and SVI objectives and gradients, split over the rows (a
    symbolic data dim) and whole (a fixed one)."""
    from mxfusion_tpu_torch.parallel import batch_sharding
    from mxfusion_tpu_torch.parallel.data_parallel import DataParallelPlan
    inf_mod = P["inference"]
    rng = np.random.default_rng(0)
    y = rng.standard_normal((160, 1)) + 2.0
    out = {}
    for name, n, map_mu in (("map", None, True), ("svi", None, False),
                            ("svi_static", 160, False)):
        m = _normal_model(P, n=n, map_mu=map_mu)
        alg = inf_mod.MAP(model=m, observed=[m.y]) if map_mu else \
            _svi(P, m)[1]
        inf = inf_mod.GradBasedInference(inference_algorithm=alg,
                                         dtype="float64")
        inf.initialize(y=y)
        ex = inf_mod.create_executor(alg, inf.params)
        plan = DataParallelPlan(_loss_factory(inf_mod), alg, inf.params,
                                [batch_sharding(mesh, 2)], 160)
        res = {"gather": plan.gather}
        for tag, executor, data in (("dp", plan.executor,
                                     plan.local([y], "cpu")),
                                    ("single", ex, [y])):
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in inf.params.trainable_params().items()}
            loss, lfg, _ = executor(leaves, inf.params.fixed_params(), data,
                                    _gen(7))
            lfg.backward()
            loss = loss.detach()
            if tag == "dp":
                loss = plan.reduce(loss, leaves.values())
                plan.finish()  # the factors' scaling back to the plain one
            res[tag] = [float(loss)] + [
                _np(leaves[k].grad) for k in sorted(leaves)
                if leaves[k].grad is not None]
        out[name] = res
    # a user function over the rows may mix them (this one centres
    # them), so the plan computes the whole data unless the function
    # declares itself row-separable (this one maps each row alone)
    from mxfusion_tpu_torch.components.functions import Function
    Variable, bt = P["Variable"], P["broadcast_to"]
    x = rng.standard_normal((160, 1))
    for name, fn, separable in (
            ("centred", lambda x: x - x.mean(0, keepdim=True), False),
            ("declared", lambda x: 2.0 * x + 1.0, True)):
        m = P["Model"]()
        m.n = Variable()
        m.x = Variable(shape=(m.n, 1))
        m.mu = Variable(initial_value=0.5)
        m.s = Variable(transformation=P["PositiveTransformation"](),
                       initial_value=2.)
        f = Function(fn, input_names=["x"], output_names=["c"])
        if separable:
            f.row_separable = True
        m.c = f(m.x)
        m.y = P["Normal"].define_variable(
            mean=m.c + bt(m.mu, (m.n, 1)), variance=bt(m.s, (m.n, 1)),
            shape=(m.n, 1))
        alg = inf_mod.MAP(model=m, observed=[m.x, m.y])
        inf = inf_mod.GradBasedInference(inference_algorithm=alg,
                                         dtype="float64")
        inf.initialize(x=x, y=y)
        ex = inf_mod.create_executor(alg, inf.params)
        plan = DataParallelPlan(_loss_factory(inf_mod), alg, inf.params,
                                [batch_sharding(mesh, 2)] * 2, 160)
        res = {"gather": plan.gather}
        for tag, executor, data in (("dp", plan.executor,
                                     plan.local([x, y], "cpu")),
                                    ("single", ex, [x, y])):
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in inf.params.trainable_params().items()}
            loss, lfg, _ = executor(leaves, inf.params.fixed_params(), data,
                                    _gen(7))
            lfg.backward()
            loss = loss.detach()
            if tag == "dp":
                loss = plan.reduce(loss, leaves.values())
                plan.finish()
            res[tag] = [float(loss)] + [_np(leaves[k].grad)
                                        for k in sorted(leaves)]
        out[name] = res
    return out


def case_local_latent(P, mesh):
    """A local latent per row with an amortized posterior (the VAE's
    shape): split over the rows, each rank draws its rows' z, so the DP
    objective differs from the one-process one in value; both estimate
    the closed-form ELBO."""
    from mxfusion_tpu_torch.models import Posterior
    from mxfusion_tpu_torch.parallel import batch_sharding
    from mxfusion_tpu_torch.parallel.data_parallel import DataParallelPlan
    inf_mod = P["inference"]
    Variable, Normal, bt = P["Variable"], P["Normal"], P["broadcast_to"]
    y = np.random.default_rng(11).standard_normal((160, 1)) * 1.5
    m = P["Model"]()
    m.n = Variable()
    m.z = Normal.define_variable(
        mean=bt(Variable(value=0.), (m.n, 1)),
        variance=bt(Variable(value=1.), (m.n, 1)), shape=(m.n, 1))
    m.y = Normal.define_variable(
        mean=m.z, variance=bt(Variable(value=1.), (m.n, 1)), shape=(m.n, 1))
    q = Posterior(m)
    q.a = Variable(initial_value=0.4)
    q.s = Variable(transformation=P["PositiveTransformation"](),
                   initial_value=0.6)
    q.z.set_prior(Normal(mean=q.y * bt(q.a, (m.n, 1)),
                         variance=bt(q.s, (m.n, 1))))
    alg = inf_mod.StochasticVariationalInference(
        num_samples=2048, model=m, posterior=q, observed=[m.y])
    inf = inf_mod.GradBasedInference(inference_algorithm=alg,
                                     dtype="float64")
    inf.initialize(y=y)
    ex = inf_mod.create_executor(alg, inf.params)
    plan = DataParallelPlan(_loss_factory(inf_mod), alg, inf.params,
                            [batch_sharding(mesh, 2)], 160)
    tr, fx = inf.params.trainable_params(), inf.params.fixed_params()
    loss = plan.reduce(plan.executor(tr, fx, plan.local([y], "cpu"),
                                     _gen(3))[0].detach(), [])
    plan.finish()
    single = ex(tr, fx, [y], _gen(3))[0]
    return {"gather": plan.gather, "dp": float(loss),
            "single": float(single), "y": y}


def case_batch_loops(P, mesh):
    """DataParallelBatchLoop: mean-field SVI (split), SVGP MAP (split),
    the exact GP (gathered, caches), an explicit replicated sharding."""
    from mxfusion_tpu_torch.parallel import (DataParallelBatchLoop,
                                             replicated_sharding)
    inf_mod = P["inference"]
    rng = np.random.default_rng(1)
    y = rng.standard_normal((160, 1)) * 2.0 + 3.0
    out = {}
    for tag in ("dp", "single", "explicit"):
        m = _normal_model(P)
        q, alg = _svi(P, m)
        loop = inf_mod.BatchInferenceLoop() if tag == "single" else \
            DataParallelBatchLoop(mesh)
        kw = {"data_sharding": [replicated_sharding(mesh)]} \
            if tag == "explicit" else {}
        inf, losses = _train(P, m, alg, loop, 60, 0.1, {"y": y}, **kw)
        out["svi_" + tag] = (losses, float(inf.params[q.mu.factor.mean]))
    out["y_mean"] = float(y.mean())
    X, Y = _gp_data(2)
    Z0 = np.linspace(0, 4, 8)[:, None]
    for tag in ("dp", "single"):
        m = _svgp(P, Z0)
        alg = inf_mod.MAP(model=m, observed=[m.X, m.Y])
        loop = inf_mod.BatchInferenceLoop() if tag == "single" else \
            DataParallelBatchLoop(mesh)
        inf, losses = _train(P, m, alg, loop, 10, 0.05, {"X": X, "Y": Y})
        out["svgp_" + tag] = (losses, _state(inf))
        m = _exact_gp(P)
        alg = inf_mod.MAP(model=m, observed=[m.X, m.Y])
        loop = inf_mod.BatchInferenceLoop() if tag == "single" else \
            DataParallelBatchLoop(mesh)
        inf, losses = _train(P, m, alg, loop, 10, 0.05, {"X": X, "Y": Y})
        out["gp_" + tag] = (losses, _state(inf), len(inf.params.fixed))
    return out


def case_minibatch(P, mesh):
    """DataParallelMinibatchLoop with batches_per_call, its convergence
    and its divisibility check."""
    from mxfusion_tpu_torch.parallel import DataParallelMinibatchLoop
    inf_mod = P["inference"]
    X, Y = _gp_data(3, 240)
    Z0 = np.linspace(0, 4, 12)[:, None]
    out = {}
    for tag in ("dp", "single"):
        m = _svgp(P, Z0)
        kw = dict(batch_size=40, rv_scaling={m.Y: 240 / 40},
                  batches_per_call=2)
        loop = DataParallelMinibatchLoop(mesh, **kw) if tag == "dp" \
            else inf_mod.MinibatchInferenceLoop(**kw)
        inf, losses = _train(P, m, inf_mod.MAP(model=m, observed=[m.X, m.Y]),
                             loop, 3, 0.05, {"X": X, "Y": Y})
        out["svgp_" + tag] = (losses, _state(inf), loop.h2d_copies)
    rng = np.random.default_rng(0)
    y = rng.standard_normal((640, 1)) * 2.0 + 3.0
    m = _normal_model(P)
    q, alg = _svi(P, m, S=8)
    inf, _ = _train(P, m, alg, DataParallelMinibatchLoop(
        mesh, batch_size=160, rv_scaling={m.y: 640 / 160}), 40, 0.1,
        {"y": y})
    out["svi_mu"] = (float(inf.params[q.mu.factor.mean]), float(y.mean()))
    m = _normal_model(P)
    q, alg = _svi(P, m)
    try:
        _train(P, m, alg, DataParallelMinibatchLoop(
            mesh, batch_size=102, rv_scaling={m.y: 160 / 102}), 2, 0.1,
            {"y": y[:160]})
        out["divisible"] = None
    except ValueError as e:
        out["divisible"] = str(e)
    return out


def case_device_loop(P, mesh):
    """DeviceMinibatchLoop over a sharded resident dataset: the global
    shuffle (rows assembled by all_reduce), shard-local shuffles, and
    their checks; the NGD loops over sharded data."""
    from mxfusion_tpu_torch.parallel import batch_sharding
    inf_mod = P["inference"]
    rng = np.random.default_rng(7)
    y = rng.standard_normal((160, 1)) + 2.5
    out = {}
    for tag, B, local, sharded in (("global", 40, False, True),
                                   ("single", 40, False, False),
                                   ("local", 40, True, True),
                                   ("full_global", 160, False, True),
                                   ("full_local", 160, True, True)):
        m = _normal_model(P)
        q, alg = _svi(P, m)
        loop = inf_mod.DeviceMinibatchLoop(
            batch_size=B, rv_scaling={m.y: 160 / B},
            shard_local_shuffle=local)
        kw = {"data_sharding": [batch_sharding(mesh, 2)]} if sharded else {}
        inf, losses = _train(P, m, alg, loop, 8 if B == 160 else 30, 0.1,
                             {"y": y}, **kw)
        out[tag] = (losses, float(inf.params[q.mu.factor.mean]))
    out["y_mean"] = float(y.mean())
    errors = []
    for B, kw in ((42, {"data_sharding": [batch_sharding(mesh, 2)]}),
                  (40, {})):
        m = _normal_model(P)
        q, alg = _svi(P, m, S=4)
        try:
            _train(P, m, alg, inf_mod.DeviceMinibatchLoop(
                batch_size=B, rv_scaling={m.y: 160 / B},
                shard_local_shuffle=True), 1, 0.1, {"y": y}, **kw)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    X, Y = _gp_data(4, 120)
    Z0 = np.linspace(0.1, 3.9, 6)[:, None]
    for tag in ("dp", "single"):
        kw = {"data_sharding": [batch_sharding(mesh, 2)] * 2} \
            if tag == "dp" else {}
        m = _svgp(P, Z0)
        inf, losses = _train(P, m, inf_mod.MAP(model=m, observed=[m.X, m.Y]),
                             inf_mod.NaturalGradientLoop(
                                 m.Y.factor, nat_learning_rate=0.5),
                             6, 0.02, {"X": X, "Y": Y}, **kw)
        out["ngd_" + tag] = (losses, _state(inf))
        m = _svgp(P, Z0)
        inf, losses = _train(P, m, inf_mod.MAP(model=m, observed=[m.X, m.Y]),
                             inf_mod.NaturalGradientMinibatchLoop(
                                 m.Y.factor, batch_size=40,
                                 rv_scaling={m.Y: 3.0},
                                 nat_learning_rate=0.2),
                             3, 0.02, {"X": X, "Y": Y}, **kw)
        out["ngd_mb_" + tag] = (losses, _state(inf))
    return out


def case_shard_map(P, mesh):
    """make_shard_map_step (split, and gather_data on the exact GP) and
    make_cache_refresh_step."""
    import torch
    from mxfusion_tpu_torch.parallel import (
        make_cache_refresh_step, make_shard_map_step, shard_data)
    inf_mod = P["inference"]
    rank = mesh.get_local_rank("data")
    out = {}
    rng = np.random.default_rng(3)
    y = rng.standard_normal((160, 1)) * 2.0 + 3.0
    m = _normal_model(P)
    q, alg = _svi(P, m)
    inf = inf_mod.GradBasedInference(inference_algorithm=alg,
                                     dtype="float64")
    inf.initialize(y=y[:160 // WORLD], generator=_gen(0))
    ex = inf_mod.create_executor(alg, inf.params,
                                 rv_scaling={m.y.uuid: float(WORLD)})
    step, opt = make_shard_map_step(ex, mesh, "adam", 0.1)
    tr = dict(inf.params.trainable_params())
    fx = dict(inf.params.fixed_params())
    opt_state = opt.init(tr)
    data = shard_data(mesh, [y])
    g = _gen(0)
    losses = []
    for _ in range(60):
        tr, opt_state, loss, aux = step(tr, fx, opt_state, g, data)
        losses.append(float(loss))
    out["split"] = (losses, aux, rank)

    X, Y = _gp_data(5)
    runs = {}
    for tag in ("gather", "single"):
        m = _exact_gp(P)
        alg = inf_mod.MAP(model=m, observed=[m.X, m.Y])
        inf = inf_mod.GradBasedInference(inference_algorithm=alg,
                                         dtype="float64")
        inf.initialize(X=X, Y=Y)
        ex = inf_mod.create_executor(alg, inf.params)
        tr = dict(inf.params.trainable_params())
        fx = dict(inf.params.fixed_params())
        if tag == "gather":
            step, opt = make_shard_map_step(ex, mesh, "adam", 0.05,
                                            gather_data=True)
            data = shard_data(mesh, [X, Y])
        else:
            opt = None
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in tr.items()}
            adam = torch.optim.Adam(list(leaves.values()), lr=0.05)
        losses = []
        for _ in range(25):
            if tag == "gather":
                if opt is not None:
                    opt_state, opt = opt.init(tr), None
                tr, opt_state, loss, aux = step(tr, fx, opt_state, _gen(),
                                                data)
            else:
                adam.zero_grad()
                loss, lfg, aux = ex(leaves, fx, [X, Y], _gen())
                lfg.backward()
                adam.step()
                loss = loss.detach()
            fx = {**fx, **aux}
            losses.append(float(loss))
        runs[tag] = (losses, _by_name(inf, aux))
    out["exact_gp"] = runs

    # split training of the exact GP returns no cache; one refresh step
    # gives the whole data's, equal to a one-process forward pass
    m = _exact_gp(P)
    alg = inf_mod.MAP(model=m, observed=[m.X, m.Y])
    inf = inf_mod.GradBasedInference(inference_algorithm=alg,
                                     dtype="float64")
    inf.initialize(X=X[:160 // WORLD], Y=Y[:160 // WORLD])
    ex = inf_mod.create_executor(alg, inf.params)
    step, opt = make_shard_map_step(ex, mesh, "adam", 0.05)
    tr = dict(inf.params.trainable_params())
    fx = dict(inf.params.fixed_params())
    opt_state = opt.init(tr)
    data = shard_data(mesh, [X, Y])
    for _ in range(5):
        tr, opt_state, loss, aux = step(tr, fx, opt_state, _gen(), data)
    inf.initialize(X=X, Y=Y)
    full_ex = inf_mod.create_executor(alg, inf.params)
    _, refreshed = make_cache_refresh_step(full_ex, mesh)(tr, fx, _gen(),
                                                          data)
    with torch.no_grad():
        _, _, single = full_ex(tr, fx, [X, Y], _gen())
    out["refresh"] = (aux, _by_name(inf, refreshed), _by_name(inf, single))
    return out


def case_mesh_helpers(P, mesh):
    from mxfusion_tpu_torch.parallel import (
        initialize_distributed, make_mesh_2d, shard_data)
    initialize_distributed(num_processes=1)
    initialize_distributed(num_processes=None)
    mesh2 = make_mesh_2d(2, 2)
    (arr,) = shard_data(mesh2, [np.zeros((12, 3), np.float32)])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        big, small = shard_data(mesh, [np.zeros((1001, 2), np.float32),
                                       np.float32(3.0)])
    msgs = [str(x.message) for x in w
            if issubclass(x.category, RuntimeWarning)]
    from mxfusion_tpu_torch.parallel import make_mesh
    try:   # a mesh spans every process of the group
        make_mesh(2)
        subset = None
    except ValueError as e:
        subset = str(e)
    return {"names": tuple(mesh2.mesh_dim_names), "subset": subset,
            "shape": tuple(mesh2.mesh.shape),
            "block": tuple(arr.shape), "big": tuple(big.shape),
            "msgs": msgs}


def case_samplers(P, mesh):
    """test_sharded_mcmc's three chains over shard_data (fixed shapes:
    gathered) and HMC over a symbolic data dim (split, each potential
    all-reduced)."""
    from mxfusion_tpu_torch.parallel import data_shardings, shard_data
    inf_mod = P["inference"]
    N, D = 128, 2
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D))
    y = X @ np.array([[1.0], [-0.5]]) + rng.standard_normal((N, 1)) * 0.5

    def model(symbolic):
        m = P["Model"]()
        m.n = P["Variable"]()
        rows = m.n if symbolic else N
        m.X = P["Variable"](shape=(rows, D))
        m.w = P["Normal"].define_variable(
            mean=P["broadcast_to"](P["Variable"](value=0.), (D, 1)),
            variance=P["broadcast_to"](P["Variable"](value=1.), (D, 1)),
            shape=(D, 1))
        m.f = P["dot"](m.X, m.w)
        m.y = P["Normal"].define_variable(
            mean=m.f, variance=P["broadcast_to"](
                P["Variable"](value=0.25), (rows, 1)), shape=(rows, 1))
        return m

    cases = {
        "hmc": ("HMCAlgorithm", False, dict(
            num_samples=40, num_warmup=30, num_chains=2, num_leapfrog=5,
            adapt_mass=False)),
        "sgld": ("SGLDAlgorithm", False, dict(
            num_samples=50, num_burnin=20, num_chains=2, batch_size=None,
            step_size=1e-4, step_decay_gamma=0.0)),
        "pt": ("ParallelTemperingAlgorithm", False, dict(
            num_samples=40, num_warmup=30, num_chains=2, num_temps=4,
            num_leapfrog=5)),
        "hmc_split": ("HMCAlgorithm", True, dict(
            num_samples=40, num_warmup=30, num_chains=2, num_leapfrog=5,
            adapt_mass=False)),
    }
    from mxfusion_tpu_torch.parallel import data_parallel
    reduce_mean = data_parallel._all_reduce_mean
    reductions = []

    def counted(*args):
        reductions.append(1)
        return reduce_mean(*args)
    data_parallel._all_reduce_mean = counted
    out = {}
    for name, (cls, symbolic, kw) in cases.items():
        res = {}
        reductions.clear()
        for tag in ("plain", "sharded"):
            m = model(symbolic)
            alg = getattr(inf_mod, cls)(model=m, observed=[m.X, m.y], **kw)
            inf = inf_mod.Inference(inference_algorithm=alg,
                                    dtype="float64")
            inf.initialize(X=X, y=y)
            if tag == "plain":
                ex = inf_mod.create_sampling_executor(alg, inf.params)
                data = [X, y]
            else:
                ex = inf_mod.create_sampling_executor(
                    alg, inf.params,
                    data_sharding=data_shardings(mesh, [X, y]))
                data = shard_data(mesh, [X, y])
            samples, _ = ex(inf.params.trainable_params(),
                            inf.params.fixed_params(), data, _gen(0))
            res[tag] = _np(samples[m.w.uuid])
        res["reductions"] = len(reductions)
        out[name] = res
    data_parallel._all_reduce_mean = reduce_mean
    return out


def case_serving(P, mesh, tmp):
    """BatchedPredictor(mesh=) and load_exported_predictor(mesh=) against
    the plain predictor."""
    inf_mod = P["inference"]
    X, Y = _gp_data(6, 80)
    Z0 = np.linspace(0, 4, 6)[:, None]
    m = _svgp(P, Z0)
    inf, _ = _train(P, m, inf_mod.MAP(model=m, observed=[m.X, m.Y]),
                    inf_mod.BatchInferenceLoop(), 5, 0.05,
                    {"X": X, "Y": Y})
    Xt = np.linspace(-0.5, 4.5, 30)[:, None]

    def predictor(**kw):
        return inf_mod.BatchedPredictor(
            model=m, infr_params=inf.params, observed=[m.X],
            target_variables=[m.Y.uuid], chunk_size=8, **kw)
    plain = predictor().predict(X=Xt)[0]
    sharded = predictor(mesh=mesh).predict(X=Xt)[0]
    out = {"plain": [np.asarray(a) for a in plain],
           "mesh": [np.asarray(a) for a in sharded]}
    errors = []
    for make in (lambda: predictor(mesh=mesh).export(
                     os.path.join(tmp, "no.zip"), X=Xt),
                 lambda: predictor(mesh=mesh, data_axis="model"),
                 lambda: inf_mod.BatchedPredictor(
                     model=m, infr_params=inf.params, observed=[m.X],
                     chunk_size=6, mesh=mesh)):
        try:
            make()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    path = os.path.join(tmp, "p{}.zip".format(mesh.get_local_rank("data")))
    predictor().export(path, X=Xt)
    loaded = inf_mod.load_exported_predictor(path, mesh=mesh)
    out["exported"] = [np.asarray(a) for a in loaded.predict(X=Xt)[0]]
    # a full covariance (block-diagonal over the chunks) and predictive
    # draws on 32 copies of one row: 4 chunks, one a rank
    import torch
    from mxfusion_tpu_torch.modules.gp_modules.svgp_regression import (
        SVGPRegressionMeanVariancePrediction, SVGPRegressionSamplingPrediction)
    mod = m.Y.factor
    Xs = np.full((32, 1), 2.0)
    for name, alg in (
            ("full_cov", SVGPRegressionMeanVariancePrediction(
                mod._module_graph, mod._extra_graphs[0],
                [v for _, v in mod.inputs], diagonal_variance=False)),
            ("draws", SVGPRegressionSamplingPrediction(
                mod._module_graph, mod._extra_graphs[0],
                [v for _, v in mod.inputs], noise_free=False))):
        mod.attach_prediction_algorithms(
            targets=mod.output_names, conditionals=mod.input_names,
            algorithm=alg, alg_name="svgp_predict")
        x = Xt[:24] if name == "full_cov" else Xs
        out[name] = {}
        for tag, pred in (("plain", predictor()),
                          ("mesh", predictor(mesh=mesh))):
            res = pred.predict(X=x, generator=torch.Generator().manual_seed(5))
            out[name][tag] = [np.asarray(a) for a in res[0]] \
                if isinstance(res[0], tuple) else [np.asarray(res[0])]
    # the drawing artifact, loaded with and without the mesh
    path = os.path.join(tmp, "draws{}.zip".format(
        mesh.get_local_rank("data")))
    predictor().export(path, X=Xs)
    for tag, on in (("exported_plain", None), ("exported_mesh", mesh)):
        res = inf_mod.load_exported_predictor(path, mesh=on).predict(
            X=Xs, generator=torch.Generator().manual_seed(5))
        out["draws"][tag] = [np.asarray(res[0])]
    return out


CASES = {"objective": case_objective, "local_latent": case_local_latent,
         "batch_loops": case_batch_loops,
         "minibatch": case_minibatch, "device_loop": case_device_loop,
         "shard_map": case_shard_map, "mesh_helpers": case_mesh_helpers,
         "samplers": case_samplers, "serving": case_serving}


def _worker(rank, world, port, out_dir):
    """One rank: join the group, run every case, pickle the results."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from mxfusion_tpu_torch.common.config import set_default_device
    set_default_device("cpu")
    from mxfusion_tpu_torch.parallel import initialize_distributed, make_mesh
    initialize_distributed("127.0.0.1:{}".format(port), world, rank)
    assert dist.get_world_size() == world
    mesh = make_mesh()
    P = _port()
    results = {}
    for name, fn in CASES.items():
        try:
            results[name] = fn(P, mesh, out_dir) if name == "serving" \
                else fn(P, mesh)
        except Exception:
            results[name] = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, "rank{}.pkl".format(rank)), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


# =====================================================================
# the test side
# =====================================================================

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, from one group of WORLD gloo processes."""
    out = str(tmp_path_factory.mktemp("dp"))
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    code = ("import sys; from tests.test_torch_parallel import _worker; "
            "_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), "
            "sys.argv[4])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(WORLD), str(port), out],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = []
    for r in range(WORLD):
        with open(os.path.join(out, "rank{}.pkl".format(r)), "rb") as f:
            res.append(pickle.load(f))
    return res


def _case(ranks, name):
    for r in ranks:
        assert "error" not in r[name], r[name].get("error")
    return [r[name] for r in ranks]


def _close(a, b, rtol, atol=0.0):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rtol, atol)
    else:
        np.testing.assert_allclose(np.asarray(a, dtype=float),
                                   np.asarray(b, dtype=float),
                                   rtol=rtol, atol=atol)


def test_objectives_equal_the_one_process_and_jax(ranks):
    """The split MAP and SVI objectives and gradients equal the one-process
    values on every rank (reassociation only); a fixed data dim makes the
    objective whole. The MAP objective equals JAX's."""
    import jax
    import mxfusion_tpu as mj
    from mxfusion_tpu.components.distributions import Normal as JNormal
    from mxfusion_tpu.components.functions.operators import \
        broadcast_to as jbroadcast
    from mxfusion_tpu.components.variables import \
        PositiveTransformation as JPositive
    from mxfusion_tpu.inference import (MAP as JMAP,
                                        GradBasedInference as JInference,
                                        create_executor as jcreate)
    results = _case(ranks, "objective")
    for r in results:
        assert not r["map"]["gather"] and not r["svi"]["gather"]
        assert r["svi_static"]["gather"]
        for name in ("map", "svi", "svi_static"):
            _close(r[name]["dp"], r[name]["single"], 1e-12, 1e-14)
    y = np.random.default_rng(0).standard_normal((160, 1)) + 2.0
    m = mj.Model()
    m.n = mj.Variable()
    m.mu = mj.Variable(initial_value=0.5)
    m.s = mj.Variable(transformation=JPositive(), initial_value=5.)
    m.y = JNormal.define_variable(mean=jbroadcast(m.mu, (m.n, 1)),
                                  variance=jbroadcast(m.s, (m.n, 1)),
                                  shape=(m.n, 1))
    alg = JMAP(model=m, observed=[m.y])
    inf = JInference(inference_algorithm=alg, dtype="float64")
    inf.initialize(y=y)
    ex = jcreate(alg, inf.params)
    jloss = float(ex(inf.params.trainable_params(),
                     inf.params.fixed_params(), [y],
                     jax.random.PRNGKey(0))[0])
    for r in results:
        np.testing.assert_allclose(r["map"]["dp"][0], jloss, rtol=1e-12)


def test_functions_over_the_rows_gather_unless_declared(ranks):
    """A user Function over the data rows (a centring, which mixes them)
    makes the plan compute the whole data, and the objective and its
    gradients equal the one-process ones; a Function that declares
    ``row_separable = True`` is split, with the same equality."""
    for r in _case(ranks, "objective"):
        assert r["centred"]["gather"] and not r["declared"]["gather"]
        for name in ("centred", "declared"):
            _close(r[name]["dp"], r[name]["single"], 1e-12, 1e-14)


def test_data_parallel_batch_loop(ranks):
    """test_data_parallel_batch_loop_converges,
    test_svgp_sharded_training_matches_single_device and
    test_batch_loop_honors_explicit_data_sharding, on trajectories: every
    rank's equals the one-process run's; the exact GP (gathered) to the
    bit, its caches included."""
    for r in _case(ranks, "batch_loops"):
        _close(r["svi_dp"], r["svi_single"], 1e-10)
        _close(r["svi_explicit"], r["svi_single"], 0, 0)
        assert abs(r["svi_dp"][1] - r["y_mean"]) < 0.4
        _close(r["svgp_dp"], r["svgp_single"], 1e-10, 1e-12)
        _close(r["gp_dp"][:2], r["gp_single"][:2], 0, 0)
        assert r["gp_dp"][2] == r["gp_single"][2] == 3


def test_data_parallel_minibatch_loop(ranks):
    """batches_per_call = 2 on split batches equals the one-process
    loop's trajectory; test_dp_minibatch_loop_converges; the divisibility
    check up front."""
    for r in _case(ranks, "minibatch"):
        _close(r["svgp_dp"][0], r["svgp_single"][0], 1e-10)
        # Adam divides by sqrt(v): a component whose gradient is near 0
        # carries the reassociation further than the losses do
        _close(r["svgp_dp"][1], r["svgp_single"][1], 1e-7, 1e-10)
        # 6 batches an epoch, 3 calls: one copy a call on each rank
        assert r["svgp_dp"][2] == r["svgp_single"][2] == 9
        mu, mean = r["svi_mu"]
        assert abs(mu - mean) < 0.5
        assert "divisible" in r["divisible"]


def test_device_loop_over_a_sharded_dataset(ranks):
    """The resident dataset sharded: the global shuffle's trajectory
    equals the one-process loop's; shard-local shuffles converge, equal
    the global one at B = N, and check their preconditions; both NGD
    loops over sharded data equal the one-process runs."""
    for r in _case(ranks, "device_loop"):
        _close(r["global"], r["single"], 1e-10)
        for tag in ("global", "local"):
            assert abs(r[tag][1] - r["y_mean"]) < 0.6
        _close(r["full_local"], r["full_global"], 1e-6, 1e-8)
        assert "divisible" in r["errors"][0]
        assert "data_sharding" in r["errors"][1]
        _close(r["ngd_dp"], r["ngd_single"], 1e-9, 1e-12)
        _close(r["ngd_mb_dp"], r["ngd_mb_single"], 1e-9, 1e-12)


def test_shard_map_step_and_cache_refresh(ranks):
    """test_shard_map_step_runs_and_descends,
    test_shard_map_exact_gp_trains_with_cache and
    test_cache_refresh_after_ungathered_shard_map_training."""
    for r in _case(ranks, "shard_map"):
        losses, aux, _ = r["split"]
        assert losses[-1] < losses[0]
        assert aux == {}
        gather, single = r["exact_gp"]["gather"], r["exact_gp"]["single"]
        _close(gather, single, 1e-10, 1e-12)
        assert len(gather[1]) == 3
        split_aux, refreshed, one = r["refresh"]
        assert split_aux == {}
        assert len(refreshed) == 3
        _close(refreshed, one, 1e-12, 1e-14)
    first = ranks[0]["shard_map"]["split"][0]
    for r in ranks[1:]:
        _close(r["shard_map"]["split"][0], first, 0, 0)


def test_mesh_helpers(ranks):
    """test_make_mesh_2d_axes, test_initialize_distributed_single_host_noop,
    test_shard_data_divides_by_named_axis_not_total_devices and
    test_shard_data_warns_when_large_array_replicates."""
    for r in _case(ranks, "mesh_helpers"):
        assert r["names"] == ("data", "model")
        assert r["shape"] == (2, 2)
        assert r["block"] == (6, 3)
        assert r["big"] == (1001, 2)
        assert len(r["msgs"]) == 1 and "REPLICATING" in r["msgs"][0]
        assert "spans every process" in r["subset"]


@pytest.mark.parametrize("name", ["hmc", "sgld", "pt", "hmc_split"])
def test_sharded_chains_equal_unsharded(ranks, name):
    """test_sharded_mcmc's tolerance (rtol 2e-4, atol 1e-5); the split
    HMC all-reduces every potential and gradient."""
    for r in _case(ranks, "samplers"):
        np.testing.assert_allclose(r[name]["sharded"], r[name]["plain"],
                                   rtol=2e-4, atol=1e-5)
        # fixed data dims gather the rows; the split HMC all-reduces each
        # of its 1 + 5 * (30 + 40) potentials
        assert r[name]["reductions"] == (351 if name == "hmc_split" else 0)


def test_mesh_serving(ranks):
    """Whole chunks dealt to the ranks, their outputs all-gathered: the
    live predictor and the artifact equal the plain predictor, a full
    covariance too (its chunks' blocks). Predictive draws: the first
    rank's chunk draws the plain predictor's numbers, the others draw
    from streams of their own (ROADMAP §C), so no two of the four chunks
    of one repeated row draw alike. Exporting a mesh predictor, an
    unknown axis and a chunk the axis does not divide raise, as in
    JAX."""
    for r in _case(ranks, "serving"):
        _close(r["mesh"], r["plain"], 1e-12, 1e-14)
        _close(r["exported"], r["plain"], 1e-12, 1e-14)
        _close(r["full_cov"]["mesh"], r["full_cov"]["plain"], 1e-12, 1e-14)
        assert r["full_cov"]["mesh"][1].shape == (1, 24, 24)
        assert r["full_cov"]["mesh"][1][0, 0, 8] == 0.0
        plain, mesh = r["draws"]["plain"][0], r["draws"]["mesh"][0]
        assert mesh.shape == plain.shape == (1, 32, 1)
        _close(mesh[:, :8], plain[:, :8], 0, 0)
        chunks = [mesh[0, i:i + 8, 0] for i in range(0, 32, 8)]
        for i in range(4):
            for j in range(i):
                assert not np.array_equal(chunks[i], chunks[j])
        assert "export()" in r["errors"][0]
        assert "not an axis" in r["errors"][1]
        assert "divisible" in r["errors"][2]


def test_mesh_serving_of_a_drawing_artifact(ranks):
    """The exported sampling prediction draws its base draws from the
    caller's generator as the live one does: loaded alone it equals the
    plain predictor's draws, and loaded over the mesh the live mesh
    predictor's, bit for bit (``_rank_generator``: the first rank's
    chunk on the caller's stream, every other rank on its own)."""
    for r in _case(ranks, "serving"):
        d = r["draws"]
        _close(d["exported_plain"], d["plain"], 0, 0)
        _close(d["exported_mesh"], d["mesh"], 0, 0)
        assert not np.array_equal(d["exported_mesh"][0], d["plain"][0])


def test_local_latent_draws_differ_in_value_not_in_distribution(ranks):
    """ROADMAP §C's deliberate difference: a rank draws the local latent
    of its own rows, so the split objective is another draw of the same
    estimator. At S = 2048 both lie within 1% of the closed-form ELBO
    (their Monte-Carlo spread is about 0.1% of it) and differ from each
    other."""
    q_a, q_s = 0.4, 0.6
    for r in _case(ranks, "local_latent"):
        assert not r["gather"]
        y = r["y"][:, 0]
        mean = q_a * y
        elbo = np.sum(-np.log(2 * np.pi) - 0.5 * ((y - mean) ** 2 + q_s)
                      - 0.5 * (mean ** 2 + q_s)
                      + 0.5 * np.log(2 * np.pi * np.e * q_s))
        for tag in ("dp", "single"):
            np.testing.assert_allclose(r[tag], -elbo, rtol=1e-2)
        assert r["dp"] != r["single"]
