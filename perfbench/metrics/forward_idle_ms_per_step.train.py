"""forward_idle_ms_per_step.train: device idle time inside the
executor's env build and the SVGP bound (``executor.env``,
``svgp.bound``) per optimizer step."""
from perfbench.lib.spans import span_ms_per

SPANS = ("executor.env", "svgp.bound")


def read(trace, cell):
    return span_ms_per(trace, SPANS, "steps", idle=True)
