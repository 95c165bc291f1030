"""The yardstick on the CPU: the bounds and FLOP formulas against hand
counts, the metric readers against a small recorded trace, the check for
JAX in the process, and the names and units of BENCHMARK.json."""
import json
import os
import re
import subprocess
import sys
import types

import pytest

from perfbench.configs import dgp2_rbf_m100_d90 as dgp
from perfbench.configs import svgp_rbf_m1000_d8 as svgp
from perfbench.lib import bounds, harness
from perfbench.lib.trace import WINDOW_MARK, Trace


def test_rbf_bound_by_hand():
    # S = 1, N = M = 2, D = 1, one lengthscale: bytes 4 (2 + 2 + 1 + 1 + 4)
    # = 40; operations 2·4·1 + 3·4·1 + 6·4 = 44 on the CUDA cores
    assert bounds.rbf_bound(1, 2, 2, 1, 1) == max(40 / bounds.HBM_BYTES_S,
                                                  44 / bounds.FP32_FLOP_S)


def test_fused_bounds_by_hand():
    # M = 2, N = 3, D = 1: the triangle 3, inputs 3 + 2 + 3 + 1 = 9
    k2, k3 = bounds.fused_bounds(2, 3, 1)
    assert k2 == max(4 * (9 + 6) / bounds.HBM_BYTES_S,
                     3 * (2 * 3 * 3 + 2 * 2 * 3) / bounds.TF32_FLOP_S)
    assert k3 == max(4 * (9 + 12 + 4 + 2 + 3 + 1) / bounds.HBM_BYTES_S,
                     (2 * 18 + 4 * 6 + 6 * 6) / bounds.TF32_FLOP_S)


def test_svgp_flops_by_hand():
    cfg = {"num_inducing": 2, "input_dim": 3}
    # per batch row: 2MD + M² + 2M² + 2M = 12 + 4 + 8 + 4 = 28; M×M work
    # 2·8 + 16/3 + 8/3 + 8 + 4 = 36
    assert svgp.flops_per_step(cfg, 5) == pytest.approx(3 * (28 * 5 + 36))
    # 2MD + 3M² + 6M = 12 + 12 + 12
    assert svgp.flops_per_row(cfg) == 36


@pytest.mark.parametrize("ard", [False, True])
def test_dgp_flops_by_hand(ard):
    cfg = {"num_inducing": 2, "num_samples": 3, "input_dim": 4,
           "hidden_dims": [3], "output_dim": 1, "ard": ard}
    B = 5
    # layer 0 (s = 1, d = 4, w = 3): 2MBd 80 + M²B 20 + 2MBw 60 + 2M²B 40
    # + the inner mean 2Bdw 120; layer 1 (s = 3, d = 3, w = 1): 3 (60 + 20
    # + 20 + 40); each layer's M×M work 16 + 16/3 + 8/3 = 24
    want = 80 + 20 + 60 + 40 + 120 + 3 * (60 + 20 + 20 + 40) + 2 * 24
    assert dgp.flops_per_step(cfg, B) == pytest.approx(3 * want)
    # one lengthscale a layer, or one an input of the layer under ARD
    L0, L1 = (4, 3) if ard else (1, 1)
    assert dgp.k1_launches_per_step(cfg, B) == [
        (1, 2, 2, 4, L0), (1, 2, 5, 4, L0), (1, 2, 2, 3, L1),
        (3, 2, 5, 3, L1)]


@pytest.mark.parametrize("ard", [False, True])
def test_svgp_k1_launches_by_hand(ard):
    cfg = {"num_inducing": 2, "input_dim": 3, "ard": ard}
    L = 3 if ard else 1
    assert svgp.k1_launches_per_step(cfg, 5) == [(1, 2, 2, 3, L)]
    assert svgp.k1_launches_per_chunk(cfg, 7) == [(1, 2, 2, 3, L),
                                                  (1, 2, 7, 3, L)]


def recorded_trace():
    """A window of 100 µs holding two steps: K2 once a step, K3's three
    kernels once a step, one copy each way, K1 twice; the device busy
    60 µs of it."""
    def ev(name, ts, dur, cat="kernel"):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    events = [
        ev(WINDOW_MARK, 1000, 100, "user_annotation"),
        ev("aten::mm", 1000, 30, "cpu_op"),
        ev("(anonymous namespace)::fused_fwd_kernel(float const*)", 1000, 10),
        ev("(anonymous namespace)::fused_bwd_de_kernel(float)", 1010, 5),
        ev("(anonymous namespace)::fused_bwd_du_kernel(float)", 1015, 5),
        ev("(anonymous namespace)::reduce_parts_kernel(int)", 1020, 2),
        ev("Memcpy HtoD (Pageable -> Device)", 1030, 4, "gpu_memcpy"),
        ev("cudaStreamSynchronize", 1040, 30, "cuda_runtime"),
        ev("(anonymous namespace)::fused_fwd_kernel(float const*)", 1070, 10),
        ev("(anonymous namespace)::fused_bwd_de_kernel(float)", 1080, 5),
        ev("(anonymous namespace)::fused_bwd_du_kernel(float)", 1085, 5),
        ev("(anonymous namespace)::reduce_parts_kernel(int)", 1090, 2),
        ev("void (anonymous namespace)::rbf_gram_kernel<true>(float)",
           1092, 1),
        ev("void (anonymous namespace)::rbf_gram_kernel<true>(float)",
           1093, 1),
        ev("Memcpy DtoH (Device -> Pageable)", 1094, 4, "gpu_memcpy"),
        ev("void potrf_cta_lower_batch<float>(int)", 1200, 5),  # outside
    ]
    return Trace(events, {"steps": 2, "requests": 2, "chunks": 1,
                          "rows": 10})


class FakeCell:
    def fused_shape(self):
        return 4, 16, 2

    def model_flops(self, counts):
        return 1e6 * counts["steps"]

    def k1_launches(self, counts):
        return [(1, 4, 4, 2, 1), (1, 4, 16, 2, 1)]


def reader(name):
    return harness.reader(name)


def test_trace_reduction():
    tr = recorded_trace()
    assert tr.window_s == pytest.approx(100e-6)
    # 1000-1022, 1030-1034, 1070-1098
    assert tr.busy_s == pytest.approx(54e-6)
    assert tr.kernels("fused_fwd_kernel") == (pytest.approx(20e-6), 2)
    gaps = dict(tr.idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(36e-6)
    assert tr.device_ops()[0] == ["fused_fwd_kernel", pytest.approx(20e-6)]


def test_readers_on_the_recorded_trace():
    tr, cell = recorded_trace(), FakeCell()
    assert reader("idle_share.train")(tr, cell) == pytest.approx(46.0)
    assert reader("mfu.train")(tr, cell) == pytest.approx(
        100 * 2e6 / 100e-6 / bounds.TF32_FLOP_S)
    k2, k3 = bounds.fused_bounds(4, 16, 2)
    assert reader("k2_roofline.train")(tr, cell) == pytest.approx(
        100 * 2 * k2 / 20e-6)
    assert reader("k3_roofline.train")(tr, cell) == pytest.approx(
        100 * 2 * k3 / 24e-6)
    assert reader("k1_roofline.serve")(tr, cell) == pytest.approx(
        100 * (bounds.rbf_bound(1, 4, 4, 2, 1)
               + bounds.rbf_bound(1, 4, 16, 2, 1)) / 2e-6)
    assert reader("launches_per_step.train")(tr, cell) == pytest.approx(
        12 / 2)
    assert reader("copy_ms_per_request.serve")(tr, cell) == pytest.approx(
        8e-3 / 2)
    # the Cholesky ran outside the window: nothing to read
    assert reader("linalg_ms_per_chunk.serve")(tr, cell) is None


def test_readers_leave_out_what_they_cannot_read():
    tr, cell = recorded_trace(), FakeCell()
    tr.counts["steps"] = 3   # K2 launched twice in three steps
    assert reader("k2_roofline.train")(tr, cell) is None
    assert reader("k3_roofline.train")(tr, cell) is None
    empty = Trace([{"ph": "X", "name": WINDOW_MARK, "ts": 0, "dur": 10,
                    "cat": "user_annotation"}], {"steps": 1})
    for name in ("idle_share.train", "mfu.train", "k1_roofline.train",
                 "launches_per_step.train"):
        assert reader(name)(empty, cell) is None


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "mxfusion_tpu_torch_probe",
                        types.ModuleType("mxfusion_tpu_torch_probe"))
    assert "mxfusion_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mxfusion_tpu.probe",
                        types.ModuleType("mxfusion_tpu.probe"))
    assert "mxfusion_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    """A whole run of the smallest cell, in a process of its own, leaves
    no JAX and no JAX package in ``sys.modules``."""
    code = (
        "import sys, time\n"
        "sys.path.insert(0, {root!r})\n"
        "from perfbench.lib import harness\n"
        "from perfbench.tests.tiny import TINY\n"
        "harness.run_cell('svgp.serve', 3, 0.2, 0, time.perf_counter(), "
        "device='cpu', overrides=TINY['svgp.serve'], log=lambda *a: None)\n"
        "print(harness.forbidden_modules())\n").format(
            root=str(harness.ROOT))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH",)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_benchmark_json_follows_the_contract():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for n in names + cells + metrics + [w["traffic"]
                                        for w in bench["workloads"]]:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        assert (harness.ROOT / c["file"]).is_file()
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and LINE.match(w["why"])
        data = harness.workload(w["name"])
        assert (data["config"], data["traffic"]["name"], data["chips"],
                data["why"]) == (w["config"], w["traffic"], w["chips"],
                                 w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        assert (harness.BENCH / "metrics" / (m["name"] + ".py")).is_file()
        # every cell a per-layer metric lists reports what it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                              cells))
    for cell in cells:
        assert "setup_s" in harness.cell_metrics(bench, cell, False)
        assert len(harness.cell_metrics(bench, cell, False)) >= 2
        assert harness.cell_metrics(bench, cell, True)
