"""``mxfusion_tpu_torch.util.profiling`` against
``tests/util/test_profiling_remat.py``'s first two cases: a trace is
written into the log directory and holds the annotated scope, and the
step timer gives a rate. (The remat case is
``tests/test_torch_loop_options.py``'s.) Then the package's own spans:
each path emits exactly its phases, as many times as it runs them, one
after another on the calling thread, and nothing while no profiler
records."""
import collections
import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import profile

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    MAP, BatchedPredictor, DeviceMinibatchLoop, GradBasedInference)
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.util import profiling
from mxfusion_tpu_torch.util.profiling import StepTimer, annotate, trace


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port runs on the card unless the CPU is asked for: these tests
    ask for it, and put the previous default back afterwards."""
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


def test_trace_writes_profile(tmp_path):
    log_dir = str(tmp_path / "prof")
    with trace(log_dir) as prof:
        with annotate("bench-step"):
            x = torch.ones((64, 64))
            (x @ x).sum().item()
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "bench-step" for e in events)
    assert any(e.key == "bench-step" for e in prof.key_averages())


def test_annotate_outside_a_trace_is_harmless():
    with annotate("nothing-records-this"):
        y = torch.ones(3) * 2
    assert float(y.sum()) == 6.0


def test_step_timer():
    t = StepTimer()
    x = torch.ones((8, 8))
    y = x @ x
    assert t.rate(5, y) > 0
    assert t.rate(5, {"a": y, "b": [y]}) > 0
    t.reset()
    assert t.rate(1) > 0


def test_span_outside_a_profiler_is_the_shared_null_context():
    first, second = profiling.span("loop.backward"), profiling.span("x")
    assert first is second
    assert isinstance(first, contextlib.nullcontext)
    with torch.profiler.profile() as prof:
        with profiling.span("recorded"):
            torch.ones(2).sum()
        assert profiling.span("y") is not first
    assert any(e.key == "recorded" for e in prof.key_averages())


N, D, M, B, EPOCHS = 40, 2, 6, 16, 2
STEPS = EPOCHS * -(-N // B)
CHUNK, ROWS = 8, 20                      # 2.5 chunks: the last one padded
CHUNKS = -(-ROWS // CHUNK)


def _svgp():
    m = mt.Model()
    m.n = mt.Variable()
    m.X = mt.Variable(shape=(m.n, D))
    m.noise_var = mt.Variable(transformation=PositiveTransformation(),
                              initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D, ARD=True), noise_var=m.noise_var,
        shape=(m.n, 1), inducing_inputs=mt.Variable(shape=(M, D)))
    return m


def _trained():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    m = _svgp()
    infr = GradBasedInference(
        MAP(model=m, observed=[m.X, m.Y]),
        grad_loop=DeviceMinibatchLoop(batch_size=B,
                                      rv_scaling={m.Y: N / B}),
        dtype="float64", device="cpu")
    infr.initialize(X=X[:B], Y=Y[:B])
    infr.params.update_params({
        k: torch.as_tensor(rng.standard_normal(tuple(v.shape)) * 0.5)
        for k, v in infr.params.trainable_params().items()
        if "inducing" in k})
    return m, infr, X, Y


def _train(m, infr, X, Y):
    infr.run(X=X, Y=Y, max_iter=EPOCHS, learning_rate=0.01)


def _predictor(m, infr):
    return BatchedPredictor(model=m, infr_params=infr, observed=[m.X],
                            target_variables=[m.Y.uuid], chunk_size=CHUNK)


def _serve(m, infr, X, Y):
    pred = _predictor(m, infr)
    pred.predict(X=X[:CHUNK])      # builds the executor at the chunk size
    return lambda: pred.predict(X=X[:ROWS])


def _serve_cold(m, infr, X, Y):
    """A new predictor's first request."""
    return lambda: _predictor(m, infr).predict(X=X[:ROWS])


# each path's spans and how often one run emits each
PATHS = {
    "train": {"loop.shuffle": EPOCHS, "loop.gather": STEPS,
              "executor.env": STEPS, "svgp.bound": STEPS,
              "loop.backward": STEPS, "loop.optimizer": STEPS,
              "loop.sync": EPOCHS},
    # two output leaves (mean, variance) merged and copied out; the
    # factors of Kuu and S are kept by the predictor once built, so a
    # warm request builds none and a predictor's first request one
    "serve": {"serving.to_device": 1, "serving.pad": 1,
              "executor.env": CHUNKS, "svgp.moments": CHUNKS,
              "serving.merge": 2, "serving.to_host": 2},
    "serve_cold": {"serving.to_device": 1, "serving.pad": 1,
                   "executor.env": CHUNKS, "svgp.factors": 1,
                   "svgp.moments": CHUNKS, "serving.merge": 2,
                   "serving.to_host": 2},
}
SPANS = {name for counts in PATHS.values() for name in counts}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_path_emits_its_spans_flat(path):
    m, infr, X, Y = _trained()
    if path == "train":
        def run():
            _train(m, infr, X, Y)
    else:
        run = {"serve": _serve, "serve_cold": _serve_cold}[path](
            m, infr, X, Y)
    with profile() as prof:
        run()
    spans = [e for e in prof.events() if e.name in SPANS]
    assert collections.Counter(e.name for e in spans) == PATHS[path]
    # one thread, and on it each span closes before the next opens
    assert len({e.thread for e in spans}) == 1
    ranges = sorted((e.time_range.start, e.time_range.end) for e in spans)
    for (_, end), (start, _) in zip(ranges, ranges[1:]):
        assert end <= start, (end, start)
    # without a profiler the same run records nothing and still works
    run()
