"""``BatchedPredictor``'s memo of parameter-derived values
(``inference/param_memo.py``): what a predictor serves with it is
bit-equal to the same chunks run with no memo active, for every SVGP
prediction, after the parameters change in place or are replaced, and
where an input of the factors is computed or drawn anew in every chunk;
the factors are built once per set of parameters, and nothing outside a
predictor's requests keeps anything."""
import contextlib

import numpy as np
import pytest
import torch

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    MAP, BatchedPredictor, GradBasedInference, param_memo)
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.modules.gp_modules.svgp_regression import (
    SVGPRegressionMeanVariancePrediction, SVGPRegressionSamplingPrediction)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port runs on the card unless the CPU is asked for: these tests
    ask for it, and put the previous default back afterwards."""
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


N, D, M = 40, 2, 6
CHUNK, ROWS = 8, 20                      # 2.5 chunks: the last one padded
CHUNKS = -(-ROWS // CHUNK)


def _svgp(whitened=False, inducing=None):
    """The SVGP; ``inducing(m)``, when given, makes its inducing inputs
    in the outer model."""
    m = mt.Model()
    m.n = mt.Variable()
    m.X = mt.Variable(shape=(m.n, D))
    m.noise_var = mt.Variable(transformation=PositiveTransformation(),
                              initial_value=0.1)
    Z = inducing(m) if inducing is not None else mt.Variable(shape=(M, D))
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D, ARD=True), noise_var=m.noise_var,
        shape=(m.n, 1), whitened=whitened, inducing_inputs=Z)
    return m


def _fitted(m):
    """A store for ``m`` with every parameter drawn, and test rows."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                              dtype="float32", device="cpu")
    infr.initialize(X=X, Y=Y)
    params = infr.params
    params.update_params({
        k: torch.as_tensor(rng.standard_normal(tuple(v.shape)) * 0.5,
                           dtype=torch.float32)
        for k, v in params.trainable_params().items()})
    return infr, X, Y, rng.standard_normal((ROWS, D))


def _attach(m, kind, whitened):
    mod = m.Y.factor
    observed = [v for _, v in mod.inputs]
    Alg = SVGPRegressionSamplingPrediction if kind.startswith("draws") \
        else SVGPRegressionMeanVariancePrediction
    mod.attach_prediction_algorithms(
        targets=mod.output_names, conditionals=mod.input_names,
        algorithm=Alg(mod._module_graph, mod._extra_graphs[0], observed,
                      diagonal_variance=kind.endswith("diag"),
                      noise_free=False, jitter=mod.jitter,
                      whitened=whitened),
        alg_name="svgp_predict")


def _predictor(m, infr):
    return BatchedPredictor(model=m, infr_params=infr, observed=[m.X],
                            target_variables=[m.Y.uuid], chunk_size=CHUNK)


@contextlib.contextmanager
def _no_memo(pred):
    """The predictor runs its chunks with no memo active."""
    pred._memo.scope = contextlib.nullcontext
    try:
        yield
    finally:
        del pred._memo.scope


def _serve(pred, Xt, seed=3):
    out = pred.predict(X=Xt, generator=torch.Generator().manual_seed(seed))
    leaves = out[0] if isinstance(out[0], tuple) else (out[0],)
    return [np.asarray(a) for a in leaves]


def _served_bit_equal(pred, Xt, seed=3):
    """Serve ``Xt`` with the memo and without it; assert the answers are
    bit-equal and return the memo's."""
    got = _serve(pred, Xt, seed)
    counts = pred.memo_counts
    with _no_memo(pred):
        want = _serve(pred, Xt, seed)
    assert pred.memo_counts == counts      # nothing counted without it
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    return got


KINDS = ["moments_diag", "moments_full", "draws_diag", "draws_full"]


@pytest.mark.parametrize("whitened", [False, True],
                         ids=["standard", "whitened"])
@pytest.mark.parametrize("kind", KINDS)
def test_memo_serves_the_answers_of_no_memo(kind, whitened):
    m = _svgp(whitened)
    infr, _, _, Xt = _fitted(m)
    _attach(m, kind, whitened)
    pred = _predictor(m, infr)
    for seed in (3, 4):                  # a cold request, then a warm one
        _served_bit_equal(pred, Xt, seed)
    assert pred.memo_counts == {"hits": 2 * CHUNKS - 1, "misses": 1}


def test_first_request_builds_the_factors_once():
    m = _svgp()
    infr, _, _, Xt = _fitted(m)
    pred = _predictor(m, infr)
    assert pred.memo_counts == {"hits": 0, "misses": 0}
    _serve(pred, Xt)
    assert pred.memo_counts == {"hits": CHUNKS - 1, "misses": 1}
    _serve(pred, Xt[:CHUNK])
    _serve(pred, Xt)
    assert pred.memo_counts == {"hits": 2 * CHUNKS, "misses": 1}
    # a parameter's env entry is one tensor in every chunk and request
    params = pred._infr.params
    chunk = [torch.as_tensor(Xt[:CHUNK])]
    with pred._memo.scope():
        envs = [pred._executor.build_env(params.trainable_params(),
                                         params.fixed_params(), chunk)
                for _ in range(2)]
    # and a new one each time once the scope is left
    outside = pred._executor.build_env(params.trainable_params(),
                                       params.fixed_params(), chunk)
    assert params.param_dict
    for uuid in params.param_dict:
        assert envs[0][uuid] is envs[1][uuid]
        assert outside[uuid] is not envs[0][uuid]


def test_adam_steps_in_place_rebuild_the_factors():
    m = _svgp()
    infr, _, _, Xt = _fitted(m)
    pred = _predictor(m, infr)
    before = _served_bit_equal(pred, Xt)
    store = pred._infr.params.param_dict
    tensors = list(store.values())
    opt = torch.optim.Adam(tensors, lr=0.05)
    g = torch.Generator().manual_seed(7)
    for t in tensors:
        t.grad = torch.randn(t.shape, generator=g, dtype=t.dtype)
    opt.step()                          # in place: every version moves
    assert all(store[k] is t for k, t in zip(store, tensors))
    after = _served_bit_equal(pred, Xt)
    assert not np.array_equal(before[0], after[0])
    assert pred.memo_counts == {"hits": 2 * (CHUNKS - 1), "misses": 2}


@pytest.mark.parametrize("name", ["inducing_inputs", "Y.qU_mean"])
def test_update_params_rebuilds_the_factors(name):
    from mxfusion_tpu_torch.util.carryover import name_paths
    m = _svgp()
    infr, _, _, Xt = _fitted(m)
    pred = _predictor(m, infr)
    before = _served_bit_equal(pred, Xt)
    params = pred._infr.params
    paths = name_paths([m])
    uuid = next(k for k in params.param_dict if paths.get(k) == name)
    old = params.param_dict[uuid]
    params.update_params({uuid: old + 0.25})
    after = _served_bit_equal(pred, Xt)
    assert not np.array_equal(before[0], after[0])
    assert pred.memo_counts == {"hits": 2 * (CHUNKS - 1), "misses": 2}


def _inducing_from(how):
    """Inducing inputs computed (the sum of a parameter with itself) or
    drawn (a Normal around a parameter) in the outer model, anew in every
    chunk."""
    def inducing(m):
        m.Zhalf = mt.Variable(shape=(M, D))
        if how == "function":
            m.Z = m.Zhalf + m.Zhalf
            m.Z.shape = (M, D)          # an operator's output is (1,)
        else:
            m.Z = Normal.define_variable(mean=m.Zhalf, variance=0.01,
                                         shape=(M, D))
        return m.Z
    return inducing


@pytest.mark.parametrize("how", ["function", "distribution"])
def test_inputs_made_in_every_chunk_miss_in_every_chunk(how):
    m = _svgp(inducing=_inducing_from(how))
    infr, _, _, Xt = _fitted(m)
    pred = _predictor(m, infr)
    for seed in (3, 4):
        _served_bit_equal(pred, Xt, seed)
    assert pred.memo_counts == {"hits": 0, "misses": 2 * CHUNKS}


def test_training_and_export_keep_nothing(tmp_path, monkeypatch):
    calls = []

    def spy(name):
        original = getattr(param_memo.ParamMemo, name)

        def recorded(self, *args, **kwargs):
            calls.append(name)
            return original(self, *args, **kwargs)
        monkeypatch.setattr(param_memo.ParamMemo, name, recorded)
    spy("env_value")
    spy("derived")
    m = _svgp()
    infr, X, Y, Xt = _fitted(m)
    pred = _predictor(m, infr)
    pred.export(str(tmp_path / "p.zip"), X=Xt)
    infr.run(X=X, Y=Y, max_iter=2, learning_rate=0.01)
    assert calls == []
    assert pred.memo_counts == {"hits": 0, "misses": 0}
    _serve(pred, Xt)
    assert calls and pred.memo_counts == {"hits": CHUNKS - 1, "misses": 1}


def test_altered_answer_fault_still_moves_the_served_mean():
    from perfbench.lib.faults import altered_answer
    m = _svgp()
    infr, _, _, Xt = _fitted(m)
    pred = _predictor(m, infr)
    sound = _serve(pred, Xt)[0]
    with altered_answer():
        for _ in range(2):               # memo filled: every chunk hits
            moved = _serve(pred, Xt)[0]
            rows = np.flatnonzero((moved != sound).any(axis=(0, 2)))
            assert rows.tolist() == list(range(0, ROWS, CHUNK))
    assert pred.memo_counts["misses"] == 1


def test_the_benchmark_reads_the_builds_a_chunk():
    """``factor_builds_per_chunk.serve`` on a traced CPU window of the
    serving cell at a tiny size: None with no device event to read, and
    0 builds a chunk once the warm-up has built the factors; on a hand-made
    window, the spans over the chunks."""
    from perfbench.lib import harness
    from perfbench.lib.trace import WINDOW_MARK, Trace, traced
    from perfbench.tests.tiny import TINY

    read = harness.reader("factor_builds_per_chunk.serve")
    _, cell = harness.make_cell("svgp.serve", 2 ** 31 + 11, "cpu",
                                TINY["svgp.serve"])
    cell.setup(0.5)
    _, tr = traced(lambda: cell.window(**cell.trace_window()), cell.counts)
    assert tr.counts["chunks"] > 0
    assert read(tr, cell) is None
    tr.device = [{"ph": "X", "name": "k", "ts": tr.t0, "dur": 0,
                  "cat": "kernel"}]
    assert read(tr, cell) == 0.0

    def ev(name, ts, dur, cat="user_annotation"):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    window = [ev(WINDOW_MARK, 1000, 100), ev("k", 1010, 20, "kernel")]
    factors = [ev("svgp.factors", 1000 + 30 * i, 10) for i in range(3)]
    assert read(Trace(window + factors, {"chunks": 2}), None) == 1.5
    assert read(Trace(window + [ev("svgp.moments", 1040, 5)],
                      {"chunks": 2}), None) == 0.0
    assert read(Trace(window + factors, {"chunks": 0}), None) is None


def test_the_benchmark_reads_k1_over_kzx_alone():
    """``k1_kzx_roofline.serve`` on hand-made windows: K1's bound at each
    chunk's Kzx over the device time of the K1 launches made inside
    ``svgp.moments``, matched by correlation id; Kuu's launch inside
    ``svgp.factors`` is left out, so a window that builds the factors in
    every chunk and one that builds none read alike; None where the
    launches do not come to one a chunk or no span is there."""
    import types

    from perfbench.configs import svgp_rbf_m1000_d8 as config
    from perfbench.lib import harness
    from perfbench.lib.bounds import rbf_bound
    from perfbench.lib.trace import WINDOW_MARK, Trace

    read = harness.reader("k1_kzx_roofline.serve")
    cfg = config.CONFIG
    cell = types.SimpleNamespace(cfg=cfg, traffic={"chunk": 8192},
                                 config=config)
    bound = rbf_bound(1, cfg["num_inducing"], 8192, cfg["input_dim"],
                      config.lengthscales(cfg))

    def ev(name, ts, dur, cat="user_annotation", corr=None):
        e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    def chunk(t, corr, factors):
        """A chunk at ``t``: with ``factors``, Kuu launched in
        ``svgp.factors``; Kzx launched in ``svgp.moments``, 40 µs on the
        device."""
        out = [ev("svgp.moments", t + 20, 10),
               ev("cudaLaunchKernel", t + 22, 1, "cuda_runtime", corr),
               ev("void rbf_gram_kernel<true>(...)", t + 30, 40, "kernel",
                  corr)]
        if factors:
            out += [ev("svgp.factors", t, 10),
                    ev("cudaLaunchKernel", t + 2, 1, "cuda_runtime",
                       corr + 100),
                    ev("void rbf_gram_kernel<true>(...)", t + 5, 7,
                       "kernel", corr + 100)]
        return out

    window = [ev(WINDOW_MARK, 1000, 300)]
    for factors in (False, True):
        events = window + chunk(1000, 1, factors) + chunk(1100, 2, factors)
        got = read(Trace(events, {"chunks": 2}), cell)
        assert got == pytest.approx(100.0 * 2 * bound / 80e-6)
        assert read(Trace(events, {"chunks": 3}), cell) is None
    assert read(Trace(window + [ev("k", 1010, 5, "kernel")],
                      {"chunks": 2}), cell) is None


def test_inference_mode_keeps_nothing_and_answers_alike():
    """Tensors made in inference mode keep no version: a first request
    under ``torch.inference_mode`` builds the factors in every chunk and
    keeps nothing; a later request outside it builds them once."""
    m = _svgp()
    infr, _, _, Xt = _fitted(m)
    pred = _predictor(m, infr)
    with torch.inference_mode():
        got = _serve(pred, Xt)
    assert pred.memo_counts == {"hits": 0, "misses": CHUNKS}
    want = _served_bit_equal(pred, Xt)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert pred.memo_counts == {"hits": CHUNKS - 1, "misses": CHUNKS + 1}
