"""What the readers of the program's spans share.

The port marks the phases of its hot paths with ``record_function``
ranges while a profiler records (``mxfusion_tpu_torch.util.profiling.
span``): flat leaf phases on the calling thread, each a
``user_annotation`` host event. A reader sums, over the spans of the
names it is given, clipped to the traced window, either their length or
the device's idle time inside them (a span's length less its overlap
with the device's busy intervals), per unit of a count of the window's
work.

The profiler stamps host events and device events with two clocks,
and on the H100's machine the offset between them moves by up to 2% of
the time elapsed, from the window's start or from a point inside it,
and jumps between windows: tens of ms by a window's end. So the
device's events are first put on the host's clock through their
launches. Each device event carries the correlation id of the runtime
or driver call that launched it, and none starts before its launch.
An event that starts after a gap on the device, and whose (start −
launch) lies within ``SLACK`` of the lower envelope of (start − launch)
over the launches (no steeper than ``DRIFT``), is one the device waited
for: it started a launch latency (a few µs) after its launch, so its
(start − launch) is the clocks' offset there. Between two such anchors
the offset runs linearly on the device's clock, and each device event
maps onto the host's clock through it, its start and its end alike: an
event the device waited for starts at its launch (the latency counts as
busy), and a busy stretch keeps its length up to the clocks' rates.

A reader returns None where it has nothing to read: no device event in
the window (a CPU run), or no program span at all (a program that opens
none). A name that is absent while other spans are present reads 0.0:
the phase did not run.
"""
import bisect

from .trace import device_busy

# every span the port opens
PROGRAM_SPANS = (
    "loop.shuffle", "loop.gather", "executor.env", "svgp.bound",
    "loop.backward", "loop.optimizer", "loop.sync", "serving.to_device",
    "serving.pad", "svgp.factors", "svgp.moments", "serving.merge",
    "serving.to_host")
# the steepest the envelope may rise or fall, µs a µs: above the 2% the
# offset was seen to move, so that it meets every event the device waited
# for; such an event lies within SLACK µs of it, and after a device gap
# of at least GAP µs (queued kernels follow each other closer)
DRIFT = 0.05
SLACK = 10.0
GAP = 5.0
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def spans(trace, names):
    """[(start, end)] of the window's program spans named in ``names``,
    clipped to the window, in the trace's microseconds."""
    out = []
    for e in trace.host:
        if e.get("cat") == "user_annotation" and e.get("name") in names:
            a = max(e["ts"], trace.t0)
            b = min(e["ts"] + e.get("dur", 0), trace.t1)
            if b > a:
                out.append((a, b))
    return out


def _correlation(e):
    args = e.get("args")
    return args.get("correlation") if isinstance(args, dict) else None


def _anchors(trace):
    """[(device start, offset)] of the events the device waited for,
    in order (see the module's docstring)."""
    launch = {}
    for e in trace.host:
        c = _correlation(e) if e.get("cat") in LAUNCH_CATS else None
        if c is not None:
            launch[c] = e["ts"]
    pairs = sorted(((launch[_correlation(e)], e) for e in trace.device
                    if _correlation(e) in launch), key=lambda p: p[0])
    env = [e["ts"] - t for t, e in pairs]
    for i in range(1, len(env)):
        env[i] = min(env[i], env[i - 1] + DRIFT * (pairs[i][0]
                                                    - pairs[i - 1][0]))
    for i in range(len(env) - 2, -1, -1):
        env[i] = min(env[i], env[i + 1] + DRIFT * (pairs[i + 1][0]
                                                    - pairs[i][0]))
    waited = {id(e) for (t, e), low in zip(pairs, env)
              if e["ts"] - t <= low + SLACK}
    out, end = [], None
    for e in sorted(trace.device, key=lambda e: e["ts"]):
        if id(e) in waited and (end is None or e["ts"] - end >= GAP):
            out.append((e["ts"], e["ts"] - launch[_correlation(e)]))
        end = e["ts"] + e["dur"] if end is None else \
            max(end, e["ts"] + e["dur"])
    return out


def host_intervals(trace):
    """The device's busy intervals on the host's clock, merged and
    clipped to the window (see the module's docstring); with no anchor
    in the trace, the device's own."""
    anchors = _anchors(trace)
    if not anchors:
        return trace.intervals
    at = [d for d, _ in anchors]

    def host(d):
        k = bisect.bisect_left(at, d)
        if k == 0 or k == len(at):
            return d - anchors[min(k, len(at) - 1)][1]
        (d0, o0), (d1, o1) = anchors[k - 1], anchors[k]
        return d - (o0 + (o1 - o0) * (d - d0) / (d1 - d0))

    moved = []
    for e in trace.device:
        a = host(e["ts"])
        moved.append({"ts": a, "dur": host(e["ts"] + e["dur"]) - a})
    return device_busy(moved, trace.t0, trace.t1)[1]


def busy_within(intervals, starts, a, b):
    """The length of [a, b] that the sorted, disjoint ``intervals``
    (their starts in ``starts``) cover."""
    i = max(0, bisect.bisect_right(starts, a) - 1)
    busy = 0.0
    for lo, hi in intervals[i:]:
        if lo >= b:
            break
        busy += max(0.0, min(hi, b) - max(lo, a))
    return busy


def span_ms_per(trace, names, count, idle):
    """ms of the spans named in ``names`` (with ``idle``, only the
    device's idle time inside them) per unit of ``count`` (a key of the
    window's counts); None where there is nothing to read."""
    units = trace.counts.get(count)
    if not trace.device or not units or not spans(trace, PROGRAM_SPANS):
        return None
    intervals = host_intervals(trace) if idle else []
    starts = [iv[0] for iv in intervals]
    total = 0.0
    for a, b in spans(trace, names):
        total += (b - a) - busy_within(intervals, starts, a, b)
    return total / 1e3 / units
