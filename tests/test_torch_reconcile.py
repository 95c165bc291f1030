"""Graph JSON skeletons and reconciliation in the port, against the JAX
package.

The port's counterparts of the reconcile tests of
``tests/models/test_factor_graph.py`` and of the property-based fuzz of
``tests/models/test_reconcile_fuzz.py``: random factor graphs (mixed
named and unnamed nodes, operator chains, parallel same-label edges)
are built twice from one seed (fresh UUIDs), the first round-trips
through its JSON skeleton and is reconciled onto the second. The map
must be injective and total and preserve names and labeled edges,
unless the documented ambiguity warning fired. The same holds across
packages: a JAX graph's skeleton reconciles onto the port's build of the
same seed, as ``Inference.load`` of a JAX zip does, and the two
packages' skeletons agree node for node.
"""
import random
import warnings
from types import SimpleNamespace

import pytest

import mxfusion_tpu as mj
from mxfusion_tpu.components import distributions as jdist
from mxfusion_tpu.components.functions import operators as jops
from mxfusion_tpu.inference import \
    create_Gaussian_meanfield as jmeanfield

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.components import distributions as tdist
from mxfusion_tpu_torch.components.functions import operators as tops
from mxfusion_tpu_torch.inference import create_Gaussian_meanfield
from mxfusion_tpu_torch.models.factor_graph import FactorGraph

J = SimpleNamespace(pkg=mj, dist=jdist, ops=jops, meanfield=jmeanfield)
T = SimpleNamespace(pkg=mt, dist=tdist, ops=tops,
                    meanfield=create_Gaussian_meanfield)


def simple_model(P):
    m = P.pkg.Model()
    m.mu = P.dist.Normal.define_variable(mean=0., variance=10., shape=(1,))
    m.s = P.dist.Gamma.define_variable(alpha=2., beta=2., shape=(1,))
    m.y = P.dist.Normal.define_variable(
        mean=P.ops.broadcast_to(m.mu, (5, 1)),
        variance=P.ops.broadcast_to(m.s, (5, 1)), shape=(5, 1))
    return m


def random_model(P, seed):
    """Deterministic from ``seed``: the same seed gives an isomorphic
    graph with fresh UUIDs, in either package (``test_reconcile_fuzz``'s
    generator, through the operator functions)."""
    rng = random.Random(seed)
    m = P.pkg.Model()
    pool = []
    for i in range(rng.randint(1, 3)):
        # every weakly connected component needs a named seed: name all
        # roots
        setattr(m, "root%d" % i, P.pkg.Variable(shape=(1,)))
        pool.append(getattr(m, "root%d" % i))
    for i in range(rng.randint(3, 10)):
        kind = rng.random()
        if kind < 0.35:
            v = P.dist.Normal.define_variable(
                mean=rng.choice(pool), variance=rng.choice(pool),
                shape=(1,))
        elif kind < 0.5:
            v = P.dist.Gamma.define_variable(
                alpha=rng.choice(pool), beta=rng.choice(pool), shape=(1,))
        elif kind < 0.6:
            v = P.dist.Beta.define_variable(
                alpha=rng.choice(pool), beta=rng.choice(pool), shape=(1,))
        elif kind < 0.75:
            v = P.ops.add(rng.choice(pool), rng.choice(pool))
        elif kind < 0.85:
            v = P.ops.multiply(rng.choice(pool), rng.choice(pool))
        elif kind < 0.95:
            v = P.ops.square(rng.choice(pool)) if rng.random() < 0.5 \
                else P.ops.exp(rng.choice(pool))
        else:
            v = P.ops.broadcast_to(rng.choice(pool), (4, 1))
        if rng.random() < 0.4:
            setattr(m, "v%d" % i, v)
            v = getattr(m, "v%d" % i)
        pool.append(v)
    m.y = P.dist.Normal.define_variable(
        mean=pool[-1],
        variance=P.ops.broadcast_to(P.pkg.Variable(value=1.0), (1,)),
        shape=(1,))
    return m


def edges(graph):
    return [(u.uuid, v.uuid, k)
            for u, v, k in graph.components_graph.edges(keys=True)]


def assert_isomorphic(prev, cur, uuid_map, ambiguous, seed):
    prev_uuids = {c.uuid for c in prev.components_graph.nodes}
    cur_uuids = {c.uuid for c in cur.components_graph.nodes}
    mapped = [uuid_map[u] for u in prev_uuids if u in uuid_map]
    assert len(mapped) == len(set(mapped)), \
        "seed %d: uuid_map not injective" % seed
    assert set(mapped) <= cur_uuids, "seed %d: unknown uuids" % seed
    missing = prev_uuids - set(uuid_map)
    assert not missing, "seed %d: %d unmatched nodes" % (seed, len(missing))
    prev_names = {c.uuid: c.name for c in prev.components_graph.nodes}
    cur_names = {c.uuid: c.name for c in cur.components_graph.nodes}
    for pu, cu in uuid_map.items():
        if pu in prev_names:
            assert prev_names[pu] == cur_names[cu], \
                "seed %d: name %s -> %s" % (seed, prev_names[pu],
                                            cur_names[cu])
    if not ambiguous:
        cur_edges = set(edges(cur))
        for u, v, k in edges(prev):
            assert (uuid_map[u], uuid_map[v], k) in cur_edges, \
                "seed %d: edge (%s)-[%s]->(%s) not preserved" % (
                    seed, u, k, v)


def reconcile(skeleton_json, graphs):
    """Reconcile port ``graphs`` onto the skeletons of ``skeleton_json``;
    (uuid_map, whether the ambiguity warning fired)."""
    skels = FactorGraph.load_graphs_json(skeleton_json)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        uuid_map = FactorGraph.reconcile_graphs(graphs, skels[0], skels[1:])
    return uuid_map, any("reconcile" in str(w.message) for w in caught)


@pytest.mark.parametrize("source", [T, J], ids=["port", "jax"])
@pytest.mark.parametrize("chunk", range(4))
def test_reconcile_random_graphs_bijective_isomorphism(chunk, source):
    """100 random graphs (25 per chunk), each built by ``source`` and by
    the port from one seed: JSON round trip, reconcile onto the port's
    build, bijection and isomorphism (or the ambiguity warning)."""
    for seed in range(chunk * 25, (chunk + 1) * 25):
        prev = random_model(source, seed)
        cur = random_model(T, seed)
        uuid_map, ambiguous = reconcile([prev.as_json()], [cur])
        assert_isomorphic(prev, cur, uuid_map, ambiguous, seed)


@pytest.mark.parametrize("seed", [0, 7, 31])
def test_skeletons_agree_across_packages(seed):
    """Node for node (in insertion order): the same names, types,
    shapes, input/output names and the same labeled edges once the
    UUIDs are mapped, so that a zip's skeleton means the same to both
    packages."""
    jm, tm = random_model(J, seed), random_model(T, seed)
    jj, tj = jm.as_json(), tm.as_json()
    assert len(jj["nodes"]) == len(tj["nodes"])
    by_pos = {a["uuid"]: b["uuid"] for a, b in zip(jj["nodes"], tj["nodes"])}
    for a, b in zip(jj["nodes"], tj["nodes"]):
        assert set(a) == set(b)
        for key in ("name", "type", "inherited", "input_names",
                    "output_names"):
            assert a.get(key) == b.get(key), (key, a, b)
        assert [by_pos.get(s, s) for s in a.get("shape", [])] == \
            b.get("shape", [])
    assert sorted((by_pos[e["source"]], by_pos[e["target"]], e["label"])
                  for e in jj["edges"]) == sorted(
        (e["source"], e["target"], e["label"]) for e in tj["edges"])


@pytest.mark.parametrize("source", [T, J], ids=["port", "jax"])
def test_reconcile_simple_model(source):
    m1 = simple_model(source)
    m2 = simple_model(T)
    uuid_map, ambiguous = reconcile([m1.as_json()], [m2])
    assert not ambiguous
    for name in ("mu", "s", "y"):
        assert uuid_map[getattr(m1, name).uuid] == getattr(m2, name).uuid
    assert uuid_map[m1.y.factor.uuid] == m2.y.factor.uuid


@pytest.mark.parametrize("source", [T, J], ids=["port", "jax"])
def test_reconcile_model_and_posterior(source):
    """The posterior's unnamed parameters reconcile through the model
    variables it replicates (cross-graph identity seeds)."""
    def build(P):
        m = simple_model(P)
        return m, P.meanfield(model=m, observed=[m.y])

    m1, q1 = build(source)
    m2, q2 = build(T)
    uuid_map, _ = reconcile([m1.as_json(), q1.as_json()], [m2, q2])
    assert uuid_map[m1.mu.uuid] == m2.mu.uuid
    for latent in ("mu", "s"):
        for slot in ("mean", "variance"):
            a = dict(getattr(q1, latent).factor.inputs)[slot]
            b = dict(getattr(q2, latent).factor.inputs)[slot]
            assert uuid_map[a.uuid] == b.uuid


def test_reconcile_warns_on_ambiguous_parallel_edges():
    """Two unnamed same-label parallel edges pair positionally, in
    networkx's insertion order, and say so; a named graph stays quiet."""
    def ambiguous():
        m = mt.Model()
        m.x = mt.Variable(shape=(1,))
        m.a = tdist.Normal.define_variable(
            mean=tops.multiply(m.x, 2.0), variance=1.0, shape=(1,))
        m.b = tdist.Normal.define_variable(
            mean=tops.multiply(m.x, 2.0), variance=1.0, shape=(1,))
        return m

    m1, m2 = ambiguous(), ambiguous()
    skels = FactorGraph.load_graphs_json([m1.as_json()])
    with pytest.warns(UserWarning, match="positionally"):
        uuid_map = FactorGraph.reconcile_graphs([m2], skels[0])
    assert uuid_map[m1.a.uuid] == m2.a.uuid
    assert uuid_map[m1.b.uuid] == m2.b.uuid
    mapped = list(uuid_map.values())
    assert len(mapped) == len(set(mapped))

    skels = FactorGraph.load_graphs_json([simple_model(T).as_json()])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        FactorGraph.reconcile_graphs([simple_model(T)], skels[0])


def test_reconcile_ambiguity_warning_fires_on_parallel_unnamed():
    """One named variable feeding two unnamed same-operator consumers:
    the warning fires and the map stays injective."""
    def build():
        m = mt.Model()
        m.x = mt.Variable(shape=(1,))
        a, b = tops.exp(m.x), tops.exp(m.x)
        m.y = tdist.Normal.define_variable(
            mean=tops.add(a, b),
            variance=tops.broadcast_to(mt.Variable(value=1.0), (1,)),
            shape=(1,))
        return m

    uuid_map, ambiguous = reconcile([build().as_json()], [build()])
    assert ambiguous
    mapped = list(uuid_map.values())
    assert len(mapped) == len(set(mapped))


def test_skeleton_round_trip_keeps_nodes_edges_and_module_graphs():
    """``load_graphs_json`` rebuilds bare components with the saved
    UUIDs, names and types, every labeled edge, and a module's internal
    graphs as JSON for the recursion."""
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.modules import SVGPRegression
    m = mt.Model()
    m.X = mt.Variable(shape=(10, 2))
    m.noise_var = mt.Variable(value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=2), noise_var=m.noise_var,
        shape=(10, 1), inducing_inputs=mt.Variable(shape=(4, 2)))
    (skel,) = FactorGraph.load_graphs_json([m.as_json()])
    nodes = {c.uuid: c for c in skel.components_graph.nodes}
    assert set(nodes) == {c.uuid for c in m.components_graph.nodes}
    assert sorted(edges(skel)) == sorted(edges(m))
    module = nodes[m.Y.factor.uuid]
    assert module._skeleton_type == "SVGPRegression"
    assert len(module._module_graphs_json) == \
        len(m.Y.factor.internal_graphs)
    uuid_map = {}
    m.Y.factor.reconcile_with_module_json(uuid_map,
                                          module._module_graphs_json)
    internal = {c.uuid for g in m.Y.factor.internal_graphs
                for c in g.components_graph.nodes}
    assert set(uuid_map) == internal
    assert all(k == v for k, v in uuid_map.items())
