"""loop_idle_ms_per_step.train: device idle time inside the loop's own
work: the epoch's shuffle, each batch's gather, the optimizer's step
and the epoch's host sync (``loop.shuffle``, ``loop.gather``,
``loop.optimizer``, ``loop.sync``) per optimizer step."""
from perfbench.lib.spans import span_ms_per

SPANS = ("loop.shuffle", "loop.gather", "loop.optimizer", "loop.sync")


def read(trace, cell):
    return span_ms_per(trace, SPANS, "steps", idle=True)
