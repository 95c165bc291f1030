"""Profiling and tracing hooks.

Counterpart of ``mxfusion_tpu/util/profiling.py``: a context manager
that records a trace, named annotations for factor-level attribution
inside an objective, and a step timer for quick throughput numbers.
``trace`` is ``torch.profiler.profile`` over the CPU and, where a card
is present, CUDA activities, and writes a Chrome trace (viewable in
``chrome://tracing`` or Perfetto) into the log directory; ``annotate``
is ``torch.profiler.record_function``, plus an NVTX range on the card
(for tools that read those).

``span(name)`` marks a phase of the package's own hot paths. It
records only while a profiler is on, and is a shared null context
otherwise (under a microsecond). The spans, each a leaf phase that
never holds another on the same thread, are:

* training (``DeviceMinibatchLoop`` under ``GradBasedInference``):
  ``loop.shuffle`` (an epoch's permutation), ``loop.gather`` (a batch's
  rows), ``executor.env`` (the runtime env: bijectors, sample axes),
  ``svgp.bound`` (``SVGPRegressionLogPdf``), ``loop.backward``,
  ``loop.optimizer`` (the optimizer's step) and ``loop.sync`` (the
  epoch's one host sync of its loss);
* serving (``BatchedPredictor``): ``serving.to_device`` (the request's
  inputs to the device), ``serving.pad`` (chunking and padding),
  ``executor.env``, ``svgp.factors`` (the prediction's factors of Kuu
  and S, which depend on the parameters only: built in a predictor's
  first chunk and after a parameter changes), ``svgp.moments`` (the
  rows' moments), ``serving.merge`` (padding stripped, chunks joined on
  the device) and ``serving.to_host`` (an output leaf to numpy).

Under ``remat`` the recompute's ``executor.env`` and ``svgp.bound`` run
inside ``loop.backward``, on the autograd thread.

Two ways to read them: ``with profiling.trace(log_dir): ...`` writes a
Chrome trace in which the spans are ``user_annotation`` events on the
host's rows, beside the device's kernels (open it in Perfetto; the
profiler stamps the two with clocks that can drift apart by up to 2% of
the elapsed time, so line a kernel up with its span through its launch,
whose correlation id it carries); or run the program under ``nsys
profile`` inside ``with torch.autograd.profiler.emit_nvtx(): ...``,
which shows every span as an NVTX range beside the kernels it
launched.
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


_OFF = contextlib.nullcontext()


def span(name):
    """The package's phase ``name`` as a ``record_function`` range while
    a profiler records (``torch.profiler``, ``emit_nvtx``), the shared
    null context otherwise."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


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
