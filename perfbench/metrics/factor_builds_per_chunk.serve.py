"""factor_builds_per_chunk.serve: how often the prediction builds its
factors of Kuu and S, which depend on the parameters only: the window's
``svgp.factors`` spans per served chunk (1 where every chunk builds
them; 0 where they are built once per set of parameters, before the
window)."""
from perfbench.lib.spans import span_ms_per, spans

SPANS = ("svgp.factors",)


def read(trace, cell):
    if span_ms_per(trace, SPANS, "chunks", idle=False) is None:
        return None
    return len(spans(trace, SPANS)) / trace.counts["chunks"]
