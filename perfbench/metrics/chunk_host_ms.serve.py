"""chunk_host_ms.serve: the host's time in a chunk's env build, factors
and moments (the length of ``executor.env``, ``svgp.factors`` and
``svgp.moments``, busy device or not) per served chunk."""
from perfbench.lib.spans import span_ms_per

SPANS = ("executor.env", "svgp.factors", "svgp.moments")


def read(trace, cell):
    return span_ms_per(trace, SPANS, "chunks", idle=False)
