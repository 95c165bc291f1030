"""moments_idle_ms_per_chunk.serve: device idle time inside a chunk's
moments against Kzx, the per-row work (``svgp.moments``) per served
chunk."""
from perfbench.lib.spans import span_ms_per

SPANS = ("svgp.moments",)


def read(trace, cell):
    return span_ms_per(trace, SPANS, "chunks", idle=True)
