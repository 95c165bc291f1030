"""factor_idle_ms_per_chunk.serve: device idle time inside a chunk's env
build and the prediction's factors of Kuu and S, which depend on the
parameters only (``executor.env``, ``svgp.factors``) per served chunk."""
from perfbench.lib.spans import span_ms_per

SPANS = ("executor.env", "svgp.factors")


def read(trace, cell):
    return span_ms_per(trace, SPANS, "chunks", idle=True)
