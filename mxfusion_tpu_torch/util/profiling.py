"""Profiling and tracing hooks.

Counterpart of ``mxfusion_tpu/util/profiling.py``: a context manager
that records a trace, named annotations for factor-level attribution
inside an objective, and a step timer for quick throughput numbers.
``trace`` is ``torch.profiler.profile`` over the CPU and, where a card
is present, CUDA activities, and writes a Chrome trace (viewable in
``chrome://tracing`` or Perfetto) into the log directory; ``annotate``
is ``torch.profiler.record_function``, plus an NVTX range on the card
(for tools that read those).
"""
import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Record a profiler trace of the block into
    ``log_dir/trace_<pid>.json``; yields the ``torch.profiler.profile``
    (its ``key_averages()`` reads the same events)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, "trace_{}.json".format(os.getpid())))


@contextlib.contextmanager
def annotate(name):
    """Named trace scope; use inside ``compute()`` to attribute
    factors."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock steps/s, synchronized with the device of the value
    handed to :meth:`rate`.

    >>> timer = StepTimer()
    >>> for _ in range(n): out = step(...)
    >>> print(timer.rate(n, out))
    """

    def __init__(self):
        self.t0 = time.perf_counter()

    def reset(self):
        self.t0 = time.perf_counter()

    def rate(self, n_steps, sync_value=None):
        """``n_steps`` over the seconds since construction or
        :meth:`reset`; a tensor (or a tree of them) in ``sync_value``
        first waits for its CUDA device to finish."""
        if sync_value is not None:
            from torch.utils import _pytree as pytree
            for leaf in pytree.tree_leaves(sync_value):
                if torch.is_tensor(leaf) and leaf.is_cuda:
                    torch.cuda.synchronize(leaf.device)
        return n_steps / (time.perf_counter() - self.t0)
