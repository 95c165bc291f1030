"""``mxfusion_tpu_torch.util.profiling`` against
``tests/util/test_profiling_remat.py``'s first two cases: a trace is
written into the log directory and holds the annotated scope, and the
step timer gives a rate. (The remat case is
``tests/test_torch_loop_options.py``'s.)"""
import glob
import json
import os

import torch

from mxfusion_tpu_torch.util.profiling import StepTimer, annotate, trace


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
