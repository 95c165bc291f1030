"""The readers of the program's spans: the spans' length and the device's
idle time inside them against hand counts on a small synthetic trace,
what they read where there is nothing to read, and a traced CPU run of
each cell, whose spans are all there and whose readers read None (the
CPU has no device events)."""
import pytest
import torch

from perfbench.lib import harness
from perfbench.lib.spans import PROGRAM_SPANS, busy_within, spans
from perfbench.lib.trace import WINDOW_MARK, Trace, traced
from perfbench.tests.tiny import TINY

SEED = 2 ** 31 + 11
NEW = {
    "svgp.train": ("forward_idle_ms_per_step.train",
                   "backward_idle_ms_per_step.train",
                   "loop_idle_ms_per_step.train"),
    "svgp.serve": ("factor_idle_ms_per_chunk.serve",
                   "moments_idle_ms_per_chunk.serve",
                   "request_idle_ms_per_request.serve",
                   "chunk_host_ms.serve"),
}


def ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def synthetic(events, counts=None):
    """A window of 100 µs from 1000, the device busy 1010-1030 and
    1060-1070."""
    return Trace([ev(WINDOW_MARK, 1000, 100),
                  ev("k", 1010, 20, "kernel"),
                  ev("Memcpy HtoD", 1060, 10, "gpu_memcpy")] + events,
                 {"steps": 2, "chunks": 2, "requests": 1} if counts is None
                 else counts)


def reader(name):
    return harness.reader(name)


def test_busy_within_by_hand():
    intervals = [[10, 20], [30, 40], [50, 60]]
    starts = [10, 30, 50]
    assert busy_within(intervals, starts, 0, 100) == 30
    assert busy_within(intervals, starts, 15, 35) == 10
    assert busy_within(intervals, starts, 20, 30) == 0
    assert busy_within(intervals, starts, 55, 58) == 3
    assert busy_within([], [], 0, 10) == 0


def test_span_readers_by_hand():
    tr = synthetic([
        # straddles the window's start: clipped to 1000-1020, busy 10
        ev("executor.env", 990, 30),
        ev("svgp.bound", 1020, 20),          # busy 10, idle 10
        ev("loop.backward", 1040, 30),       # busy 10, idle 20
        # straddles the window's end: clipped to 1090-1100, idle 10
        ev("loop.sync", 1090, 30),
        ev("loop.shuffle", 1200, 5),         # outside: not read
        ev("aten::mm", 1000, 100, "cpu_op"),  # not a span
    ])
    assert spans(tr, ("executor.env",)) == [(1000, 1020)]
    # (10 + 10) µs over 2 steps
    assert reader("forward_idle_ms_per_step.train")(tr, None) == \
        pytest.approx(20e-3 / 2)
    assert reader("backward_idle_ms_per_step.train")(tr, None) == \
        pytest.approx(20e-3 / 2)
    assert reader("loop_idle_ms_per_step.train")(tr, None) == \
        pytest.approx(10e-3 / 2)
    # executor.env's whole clipped length, 20 µs, over 2 chunks
    assert reader("chunk_host_ms.serve")(tr, None) == \
        pytest.approx(20e-3 / 2)
    # executor.env's idle time, 10 µs, over 2 chunks
    assert reader("factor_idle_ms_per_chunk.serve")(tr, None) == \
        pytest.approx(10e-3 / 2)


def test_an_absent_span_reads_zero_beside_others():
    tr = synthetic([ev("svgp.factors", 1000, 10)])
    assert reader("moments_idle_ms_per_chunk.serve")(tr, None) == 0.0
    assert reader("request_idle_ms_per_request.serve")(tr, None) == 0.0
    assert reader("factor_idle_ms_per_chunk.serve")(tr, None) == \
        pytest.approx(10e-3 / 2)


@pytest.mark.parametrize("name", [m for ms in NEW.values() for m in ms])
def test_a_reader_loads_and_reads_none_without_spans_or_device(name):
    read = reader(name)
    # a program that opens no span: the parent's, say
    assert read(synthetic([ev("other", 1000, 50)]), None) is None
    # no device event in the window: a CPU run
    no_device = Trace([ev(WINDOW_MARK, 0, 100),
                       ev(PROGRAM_SPANS[0], 0, 50)],
                      {"steps": 1, "chunks": 1, "requests": 1})
    assert read(no_device, None) is None
    # nothing counted to divide by
    assert read(synthetic([ev(PROGRAM_SPANS[0], 1000, 5)], {}), None) \
        is None


@pytest.fixture
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_cpu_run_holds_the_spans(cell, few_threads):
    _, c = harness.make_cell(cell, SEED, "cpu", TINY[cell])
    c.setup(0.5)
    _, tr = traced(lambda: c.window(**c.trace_window()), c.counts)
    names = {e["name"] for e in tr.host if e.get("cat") == "user_annotation"}
    want = {"svgp.train": {"loop.shuffle", "loop.gather", "executor.env",
                           "svgp.bound", "loop.backward", "loop.optimizer",
                           "loop.sync"},
            "svgp.serve": {"serving.to_device", "serving.pad",
                           "executor.env", "svgp.factors", "svgp.moments",
                           "serving.merge", "serving.to_host"}}[cell]
    assert names & set(PROGRAM_SPANS) == want
    for name in NEW[cell]:
        assert reader(name)(tr, c) is None
    # with one device event far from every span, each span is idle
    # throughout, so the idle metrics add up to the spans' length
    tr.device = [ev("k", tr.t0, 0, "kernel")]
    tr.intervals = []
    got = {name: reader(name)(tr, c) for name in NEW[cell]}
    assert all(v > 0 for v in got.values()), got
    if cell == "svgp.serve":
        assert got["chunk_host_ms.serve"] == pytest.approx(
            got["factor_idle_ms_per_chunk.serve"]
            + got["moments_idle_ms_per_chunk.serve"])


def drifting(drift, latency=3.0, queue_at=()):
    """A window of 10.2 ms in which the host launches a 50 µs kernel
    every 100 µs, 1 µs into a 60 µs span, and the device's clock runs
    at 1 + ``drift`` of the host's (every kernel still starts inside
    the window); the launches at ``queue_at`` wait 40 µs more in the
    queue."""
    events = [ev(WINDOW_MARK, 0, 10200)]
    for i in range(100):
        t = 100.0 * i
        wait = 40.0 if i in queue_at else 0.0
        events += [
            ev("svgp.moments", t, 60),
            ev("cudaLaunchKernel", t + 1, 2, "cuda_runtime"),
            ev("k", (1 + drift) * (t + 1 + latency + wait),
               (1 + drift) * 50, "kernel")]
        events[-2]["args"] = events[-1]["args"] = {"correlation": i}
    return Trace(events, {"chunks": 100})


@pytest.mark.parametrize("drift", [0.0, 0.014, -0.014])
def test_the_device_clock_is_put_on_the_host_clock(drift):
    # each span is idle 1 µs before its launch and 9 after its kernel,
    # the launch latency counted as busy (the last kernel, past the last
    # anchor, keeps its length on the device's clock: 0.7 µs)
    read = reader("moments_idle_ms_per_chunk.serve")
    assert read(drifting(drift), None) == pytest.approx(10e-3, abs=1e-5)
    # on its own clock a drift of 1.4% moves the 51st kernel 70 µs off
    # its span
    assert drifting(drift).intervals[50][0] == pytest.approx(
        (1 + drift) * 5004)


def test_a_queued_kernel_does_not_move_the_clock():
    # three kernels wait 40 µs in the queue: each leaves its span idle
    # until its start, 41 µs after the span's; they anchor nothing, and
    # the offset between the kernels the device waited for places them
    read = reader("moments_idle_ms_per_chunk.serve")
    got = read(drifting(0.01, queue_at=(10, 50, 51)), None)
    assert got == pytest.approx((97 * 10 + 3 * 41) / 100 * 1e-3, abs=1e-5)


def test_a_kernel_that_queued_behind_a_long_one_anchors_nothing():
    # a 5 ms kernel the device waited for, then ten 20 µs kernels the host
    # launched 4.8 ms into it, which run back to back after it: their
    # (start - launch), 213-303 µs, lies below the envelope's rise from
    # the first kernel, but no device gap precedes them
    events = [ev(WINDOW_MARK, 0, 6000), ev("svgp.factors", 0, 6000)]
    launches = [(10.0, 13.0, 5000.0)] + [
        (4800.0 + 10 * k, 5013.0 + 20 * k, 20.0) for k in range(10)]
    for c, (launch, start, dur) in enumerate(launches):
        events += [ev("cudaLaunchKernel", launch, 2, "cuda_runtime"),
                   ev("k", start, dur, "kernel")]
        events[-2]["args"] = events[-1]["args"] = {"correlation": c}
    tr = Trace(events, {"chunks": 1})
    # idle 10 µs to the first launch and from the last kernel's end,
    # 5213 µs less the 3 µs of latency, to the span's end
    assert reader("factor_idle_ms_per_chunk.serve")(tr, None) == \
        pytest.approx((10 + 6000 - 5210) * 1e-3)
