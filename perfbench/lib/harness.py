"""One run of one cell: set-up, the window (traced or not), the check
against the reference, and the result line.

Everything a cell needs is found by name: ``workloads/<cell>.json``
names its configuration and traffic; ``configs/<config>.py`` (with its
``.json``) builds the model in the port; ``reference/<config>.py`` is its
plain reference; ``traffic/<kind>.py`` drives it; ``metrics/<metric>.py``
reads one per-layer metric from the traced window. ``BENCHMARK.json``
says which metrics the cell reports.
"""
import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from . import compare
from .trace import traced

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# compared by whole top-level name: the port's own name begins with the
# JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "mxfusion_tpu")


def load_json(path):
    return json.loads(Path(path).read_text())


def workload(name):
    return load_json(BENCH / "workloads" / "{}.json".format(name))


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({k.split(".")[0] for k, v in list(sys.modules.items())
                   if v is not None} & set(FORBIDDEN))


def cell_metrics(bench, cell, trace):
    """The names of the metrics a run of ``cell`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer ones."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e
                             else [])]


def reader(name):
    """The ``read(trace, cell)`` of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / "{}.py".format(name)
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def make_cell(name, seed, device, overrides=None):
    """The traffic driver's cell for workload ``name``; ``overrides``
    ({"config": {...}, "traffic": {...}}) shrink it for tests."""
    wl = workload(name)
    overrides = overrides or {}
    wl["traffic"] = {**wl["traffic"], **overrides.get("traffic", {})}
    config = importlib.import_module("perfbench.configs." + wl["config"])
    cfg = {**config.CONFIG, **overrides.get("config", {})}
    reference = importlib.import_module("perfbench.reference."
                                        + wl["config"])
    driver = importlib.import_module("perfbench.traffic."
                                     + wl["traffic"]["kind"])
    return wl, driver.Cell(wl, config, cfg, reference, seed, device)


def device_info(device, count):
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(name, seed, seconds, trace, t_start, device="cuda",
             overrides=None, log=None, control=None, fault=None,
             record=None):
    """Run cell ``name`` once. Returns the result object of the contract
    (its ``checks`` last), or raises.

    For the readings that set the limits (``calibrate.py``): ``control``
    (a precision of ``reference.common``) puts the reference at that
    precision in the program's place in the check; ``fault`` (a name of
    ``lib/faults.py``) plants that fault under set-up and the window;
    ``record``, a dict, receives every number the check computed and the
    readings behind them."""
    import torch
    from . import faults
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    bench = load_json(ROOT / "BENCHMARK.json")
    import_s = time.perf_counter() - t_start
    wl, cell = make_cell(name, seed, device, overrides)
    log("set-up: start and torch import {:.3f} s".format(import_s))
    planted = faults.FAULTS[fault]() if fault else contextlib.nullcontext()
    with planted:
        cell.setup(seconds, log)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        log("set-up {:.3f} s".format(setup_s))
        tr = None
        if trace:
            out, tr = traced(lambda: cell.window(**cell.trace_window()),
                             cell.counts)
        else:
            out = cell.window()
    failed = cell.failed(out)
    device_block = device_info(device, wl["chips"])
    if trace:
        device_block.update(busy_s=tr.busy_s, window_s=tr.window_s)
        metrics = {}
        for m in cell_metrics(bench, name, True):
            value = reader(m)(tr, cell)
            if value is not None:
                unit = next(x["unit"] for x in bench["per_layer"]
                            if x["name"] == m)
                metrics[m] = {"value": value, "unit": unit}
    else:
        e2e = {"setup_s": (setup_s, "s"), **cell.end_to_end(out)}
        metrics = {m: {"value": e2e[m][0], "unit": e2e[m][1]}
                   for m in cell_metrics(bench, name, False)}
    cell.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = cell.check(control=control)
    correct, checks = compare.judge(numbers, wl["limits"])
    log("check {:.3f} s".format(time.perf_counter() - t0))
    if record is not None:
        record.update(numbers=numbers,
                      readings=getattr(cell, "last_readings", None))
    result = {"correct": bool(correct and failed == 0),
              "attempted": cell.attempted(out), "failed": failed,
              "metrics": metrics, "device": device_block}
    if trace:
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def finite_or_text(x):
    """JSON has no infinity or NaN: such a number is written as text."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: finite_or_text(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite_or_text(v) for v in x]
    return x
