"""k1_kzx_roofline.serve: K1's bound over each served chunk's Kzx
(``rbf_bound`` at (1, M, chunk, D, L)) over the device time of the K1
launches made inside the ``svgp.moments`` span, the rows' work
(``mxfusion_tpu_torch/csrc/rbf_gram.cu``). Kuu's launch, made where the
prediction builds its factors, is left out, so the share reads alike
whether every chunk builds the factors or a predictor keeps them. A
launch is matched to its kernel by the correlation id both carry; None
unless the window holds one such launch a chunk."""
import bisect
import re

from perfbench.lib.bounds import rbf_bound
from perfbench.lib.spans import LAUNCH_CATS, _correlation, spans

KERNELS = r"rbf_gram_kernel"
SPANS = ("svgp.moments",)


def read(trace, cell):
    chunks = trace.counts.get("chunks")
    inside = sorted(spans(trace, SPANS))
    if not trace.device or not chunks or not inside:
        return None
    starts = [a for a, _ in inside]
    launched = set()
    for e in trace.host:
        c = _correlation(e) if e.get("cat") in LAUNCH_CATS else None
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if c is not None and i >= 0 and e["ts"] < inside[i][1]:
            launched.add(c)
    rx = re.compile(KERNELS)
    hits = [e["dur"] for e in trace.device if e.get("cat") == "kernel"
            and rx.search(str(e["name"])) and _correlation(e) in launched]
    seconds = sum(hits) / 1e6
    if len(hits) != chunks or seconds <= 0:
        return None
    cfg = cell.cfg
    shape = (1, cfg["num_inducing"], cell.traffic["chunk"], cfg["input_dim"],
             cell.config.lengthscales(cfg))
    return 100.0 * chunks * rbf_bound(*shape) / seconds
