"""backward_idle_ms_per_step.train: device idle time inside the backward
pass (``loop.backward``) per optimizer step."""
from perfbench.lib.spans import span_ms_per

SPANS = ("loop.backward",)


def read(trace, cell):
    return span_ms_per(trace, SPANS, "steps", idle=True)
