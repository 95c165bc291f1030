"""The traced window and its reduction to what the metric readers read.

``traced`` runs a callable under ``torch.profiler`` (CPU and CUDA
activities) inside one annotated range, with the device synchronized
before the range closes, and returns a :class:`Trace` of the Chrome
trace's events. The union of the device events' intervals over the
range is the device's busy time (``device_busy``, copied from
``chip_smoke.py``); the gaps between them are named by the host event
that overlaps them most.
"""
import bisect
import json
import os
import re
import tempfile

WINDOW_MARK = "perfbench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


def short_name(name):
    """``void ns::(anonymous namespace)::kernel<...>(...)`` -> ``kernel``,
    as ``chip_smoke.device_busy`` names kernels; a library's generic
    wrapper (``cutlass::Kernel2<cutlass_80_simt_sgemm_...>``) by its
    first template argument."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", str(name))
    base = re.split(r"[(<]", name)[0].split("::")[-1].strip()
    if re.fullmatch(r"Kernel\d*", base) and "<" in name:
        base = re.split(r"[<>,(]", name.split("<", 1)[1])[0]
    return base[:60].strip() or "(unnamed)"


def device_busy(device, t0, t1):
    """The union of the device events' intervals clipped to [t0, t1], in
    the trace's microseconds, and the intervals themselves (merged, in
    order)."""
    busy, end = 0.0, t0
    merged = []
    for e in sorted(device, key=lambda e: e["ts"]):
        a, b = max(e["ts"], end), min(e["ts"] + e["dur"], t1)
        if b > a:
            busy += b - a
            if merged and merged[-1][1] >= a:
                merged[-1][1] = b
            else:
                merged.append([a, b])
            end = b
    return busy, merged


class Trace:
    """The device and host events of one traced window, with the counts
    of work the harness made in it (``counts``: steps, requests, chunks,
    rows)."""

    def __init__(self, events, counts):
        marks = [e for e in events if e.get("name") == WINDOW_MARK
                 and e.get("cat") == "user_annotation"]
        if len(marks) != 1:
            raise RuntimeError("the trace holds {} window marks, not one"
                               .format(len(marks)))
        self.t0 = marks[0]["ts"]
        self.t1 = self.t0 + marks[0]["dur"]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and self.t0 <= e["ts"] < self.t1]
        self.host = [e for e in events if e.get("cat") in HOST_CATS
                     and e.get("name") != WINDOW_MARK
                     and e["ts"] < self.t1
                     and e["ts"] + e.get("dur", 0) > self.t0]
        self.counts = dict(counts)
        busy, self.intervals = device_busy(self.device, self.t0, self.t1)
        self.window_s = (self.t1 - self.t0) / 1e6
        self.busy_s = busy / 1e6

    def kernels(self, pattern):
        """(seconds, launches) of the kernels whose full name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [e for e in self.device if e.get("cat") == "kernel"
                and rx.search(str(e["name"]))]
        return sum(e["dur"] for e in hits) / 1e6, len(hits)

    def copies(self, pattern):
        """(seconds, count) of the memcpys whose name matches
        ``pattern`` (the trace names them ``Memcpy HtoD (Pageable ->
        Device)`` and the like)."""
        rx = re.compile(pattern)
        hits = [e for e in self.device if e.get("cat") == "gpu_memcpy"
                and rx.search(str(e["name"]))]
        return sum(e["dur"] for e in hits) / 1e6, len(hits)

    def device_ops(self, top=10):
        """The device operations that took most time: [[name, seconds]]."""
        by_name = {}
        for e in self.device:
            key = short_name(e["name"]) if e.get("cat") == "kernel" \
                else str(e["name"])
            by_name[key] = by_name.get(key, 0.0) + e["dur"] / 1e6
        return sorted(([k, v] for k, v in by_name.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top=10):
        """The device's idle time in the window by what the host was
        doing: each gap between busy intervals is named by the host event
        that overlaps it most (the window's own edges count as gaps);
        [[name, seconds]], summed by name."""
        edges = [self.t0] + [x for iv in self.intervals for x in iv] + \
            [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        by_name = {}
        for a, b in gaps:
            best, best_overlap = "(no host event)", 0.0
            # host events overlapping [a, b]: they start before b
            hi = bisect.bisect_left(starts, b)
            for e in host[max(0, hi - 400):hi]:
                overlap = min(b, e["ts"] + e.get("dur", 0)) - max(a, e["ts"])
                if overlap > best_overlap:
                    best, best_overlap = str(e["name"]), overlap
            by_name[best] = by_name.get(best, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in by_name.items()),
                      key=lambda kv: -kv[1])[:top]

    def breakdown(self):
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}


def traced(fn, counts_of):
    """Run ``fn()`` under the profiler; ``counts_of(result)`` gives the
    work counts of the window. Returns (fn's result, :class:`Trace`).
    The Chrome trace is written to a temporary file, read and deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_MARK):
            out = fn()
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    finally:
        os.unlink(path)
    return out, Trace(events, counts_of(out))
