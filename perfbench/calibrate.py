#!/usr/bin/env python3
"""Readings that set a cell's limits, on the card at the cell's size.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds a,b,c] [--fault NAME --fault-seeds x,y,z] \\
        [--seconds S] [--out FILE]

Each reading is one run of the cell through ``harness.run_cell``, the
path of the benchmark's own runs, with a window of ``--seconds``: for
each of ``--seeds`` the program as it is; for each of
``--control-seeds`` the control, the reference at the workload's
``control`` precision, in the program's place; for each of
``--fault-seeds`` the program with the fault ``--fault``
(``lib/faults.py``) planted. One JSON line a reading on standard output
(every number the check computed and, for training, each leaf's norms),
and all of them in ``--out``. The benchmark's own runs do not run
this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def reading(name, seed, seconds, device, control=None, fault=None,
            overrides=None):
    """One reading of the numbers that decide ``correct``; ``overrides``
    shrink the cell for tests."""
    from perfbench.lib import harness
    record = {}
    t0 = time.perf_counter()
    result = harness.run_cell(name, seed, seconds, False, t0, device=device,
                              overrides=overrides, log=lambda *a: None,
                              control=control, fault=fault, record=record)
    out = {"workload": name, "seed": seed, "control": control,
           "fault": fault, "numbers": record["numbers"],
           "correct": result["correct"],
           "seconds": time.perf_counter() - t0}
    if record["readings"]:
        # each leaf's norms (got, want), for the look behind a number
        got, want = record["readings"]
        out["losses"] = [got["losses"], want["losses"]]
        out["leaves"] = {
            kind: {k: [got[kind][k], want[kind][k]] for k in want[kind]}
            for kind in ("grad_norms", "change_norms")}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=seeds, default=[])
    parser.add_argument("--control-seeds", type=seeds, default=[])
    parser.add_argument("--fault", default=None)
    parser.add_argument("--fault-seeds", type=seeds, default=[])
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    from perfbench.lib import harness
    control = harness.workload(args.workload)["control"]
    runs = [dict(seed=s) for s in args.seeds] + \
        [dict(seed=s, control=control) for s in args.control_seeds] + \
        [dict(seed=s, fault=args.fault) for s in args.fault_seeds]
    lines = []
    for kw in runs:
        r = reading(args.workload, seconds=args.seconds, device="cuda", **kw)
        lines.append(json.dumps(harness.finite_or_text(r)))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
