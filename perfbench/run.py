#!/usr/bin/env python3
"""Run one cell of the benchmark of ``mxfusion_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the port. Set-up (data, weights
and requests made on the card from the seed, the kernels built or
loaded, the cell's shapes warmed up) is timed from the start of this
script; then the window runs for ``--seconds`` (with ``--trace 1`` a
shorter window under the profiler, whose per-layer metrics are
reported); then the timed path's output is held against the plain
reference. The last line of standard output is the result, one JSON
object; the numbers compared, each beside its limit, are the last lines
of standard error. Without a CUDA card with the chips the cell asks for,
or when JAX or the JAX package was loaded, it exits nonzero and prints
no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench.lib import harness
    chips = harness.workload(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("perfbench: needs {} CUDA device(s); torch sees {} (available: "
              "{})".format(chips, torch.cuda.device_count(),
                           torch.cuda.is_available()), file=sys.stderr)
        return 2
    # one process with few threads: the host's share of the steps is
    # dispatch, and the card's host is shared
    torch.set_num_threads(4)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print("perfbench: the run loaded {}: the benchmark must not load "
              "JAX or the JAX package".format(found), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print("check {}: {} (limit {})".format(name, c["value"], c["limit"]),
              file=sys.stderr)
    print(json.dumps(harness.finite_or_text(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
