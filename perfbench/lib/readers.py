"""What the per-layer metric files share: each file under ``metrics/``
names its kernels (where it reads any) and calls one of these with them.
A reader that finds nothing to read returns None, and the harness leaves
the metric out of the result line; a share of a roofline or of a peak is
never reported as 0.
"""
from .bounds import TF32_FLOP_S, fused_bounds, rbf_bound


def idle_share(trace, cell):
    """% of the traced window in which no operation ran on the device."""
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(trace, cell):
    """% of the card's TF32 dense peak that the window's model FLOPs
    (the configuration's formula times the work done) make over the
    traced window's wall."""
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * cell.model_flops(trace.counts) / trace.window_s \
        / TF32_FLOP_S


def launches_per(trace, count):
    """Device operations (kernels, copies, sets) in the window per unit
    of ``count`` (a key of the window's counts)."""
    n = trace.counts.get(count)
    if not trace.device or not n:
        return None
    return len(trace.device) / n


def fused_roofline(trace, cell, pattern, per_step, which):
    """% of the bound (``fused_bounds``' K2 for ``which`` 0, K3 for 1) of
    the launches of kernels matching ``pattern`` over their device time;
    None unless the window holds ``per_step`` of them a step."""
    seconds, n = trace.kernels(pattern)
    steps = trace.counts.get("steps")
    if not n or not steps or n != per_step * steps or seconds <= 0:
        return None
    return 100.0 * fused_bounds(*cell.fused_shape())[which] * steps / seconds


def rbf_roofline(trace, cell, pattern):
    """% of K1's bound over the window's launches (their shapes from the
    configuration) over the device time of kernels matching ``pattern``;
    None unless the launch count is the configuration's."""
    seconds, n = trace.kernels(pattern)
    launches = cell.k1_launches(trace.counts)
    if not n or n != len(launches) or seconds <= 0:
        return None
    return 100.0 * sum(rbf_bound(*shape) for shape in launches) / seconds


def kernel_ms_per(trace, pattern, count):
    """Device ms of kernels matching ``pattern`` per unit of ``count``."""
    seconds, n = trace.kernels(pattern)
    units = trace.counts.get(count)
    if not n or not units:
        return None
    return 1e3 * seconds / units


def copy_ms_per(trace, pattern, count):
    """Device ms of memcpys matching ``pattern`` per unit of ``count``."""
    seconds, n = trace.copies(pattern)
    units = trace.counts.get(count)
    if not n or not units:
        return None
    return 1e3 * seconds / units
