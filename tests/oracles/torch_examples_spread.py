"""Write ``tests/goldens/examples_smoke_spread.json``: the return value
of each port example (``examples/torch/``) at ``MXF_SMOKE`` size (with
the raised counts of ``SIZES`` in ``tests/test_torch_examples_a.py``) on
the CPU, for generator seeds offset by 0-7; and
``tests/goldens/examples_smoke_untrained.json``: for each random
script, the values of runs that learned nothing.

Every ``torch.Generator`` the run makes (the package's default ones
and the script's own) and torch's global generator (which draws the
networks' initial weights) are seeded with their seed plus the offset,
so each offset is another draw of the script's random starts and
Monte-Carlo samples; offset 0 is the run the tests make. The port's
examples on the card draw from other streams, and the JAX examples from
their keys, so ``tests/test_torch_examples_a.py`` holds a random
script's value to the JAX value within a multiple of these runs'
standard deviation, and keeps the untrained values outside the band.
An untrained run is the script with its iteration and sample counts cut
to one (``UNTRAINED_COUNTS``); where the value is an error against a
known truth, the error of a predictor of zeros (or of the observed
column means) is listed beside it (``TRIVIAL``). Run from the
repository root (a few minutes; Tier-1 does not run it):

    python tests/oracles/torch_examples_spread.py [script ...]
"""
import json
import os
import runpy
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "goldens", "examples_smoke_spread.json")
OUT_UNTRAINED = os.path.join(ROOT, "tests", "goldens",
                             "examples_smoke_untrained.json")
OFFSETS = range(8)
# one step or draw of everything a script iterates; two samples where
# the script averages over them, two SVI steps for the VAE, whose main()
# asserts that its loss fell
UNTRAINED_COUNTS = {"MAX_ITER": 1, "ITER": 1, "EPOCHS": 1, "NUM_SAMPLES": 2,
                    "NUM_WARMUP": 1, "NUM_BURNIN": 1, "SAMPLES": 2,
                    "WARMUP": 1}
UNTRAINED_OVERRIDE = {"variational_auto_encoder.py": {"MAX_ITER": 2}}


def _zeros_against_sin(x):
    return float(np.abs(np.sin(x)).mean())


def _column_means(g):
    """matrix_completion.py's data and its column-mean imputation
    error (the baseline the script prints)."""
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((g["K"], g["D"]))
    z_true = rng.standard_normal((g["N"], g["K"]))
    x_full = z_true @ w_true + rng.standard_normal((g["N"], g["D"])) * 0.1
    mask = (rng.random((g["N"], g["D"])) < 0.6).astype(np.float64)
    x_train = np.where(mask > 0, x_full, 0.0)
    col_mean = x_train.sum(0) / np.maximum(mask.sum(0), 1.0)
    return float(np.abs(np.broadcast_to(col_mean, x_full.shape)
                        - x_full)[mask == 0].mean())


# the error of a predictor that ignores the data, from the script's
# globals: its inputs are the script's own
TRIVIAL = {
    "bnn_regression.py": lambda g: _zeros_against_sin(np.sort(
        np.random.default_rng(0).uniform(-3, 3, (g["N"], 1)), axis=0)),
    "svgp_regression.py": lambda g: _zeros_against_sin(
        np.linspace(0, 4, 20)[:, None]),
    "matrix_completion.py": _column_means,
}


class _OffsetGenerator(torch.Generator):
    offset = 0

    def manual_seed(self, seed):
        return super().manual_seed(seed + _OffsetGenerator.offset)


def untrained(name, run_example, as_json):
    """The values of runs of ``name`` that learned nothing."""
    counts = dict(UNTRAINED_COUNTS, **UNTRAINED_OVERRIDE.get(name, {}))
    values = [as_json(run_example(name, sizes=counts))]
    if name in TRIVIAL:
        os.environ["MXF_SMOKE"] = "1"
        try:
            script = runpy.run_path(os.path.join(ROOT, "examples", "torch",
                                                 name), run_name="example")
        finally:
            os.environ.pop("MXF_SMOKE")
        values.append(TRIVIAL[name](script))
    return values


def _update(path, entries):
    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
    old.update(entries)
    with open(path, "w") as f:
        json.dump({k: old[k] for k in sorted(old)}, f, indent=1)
        f.write("\n")


def main(names):
    sys.path.insert(0, ROOT)
    from mxfusion_tpu_torch.common.config import set_default_device
    from tests.test_torch_examples_a import BANDS, as_json, run_example
    set_default_device("cpu")
    torch.set_num_threads(1)
    spread, nulls = {}, {}
    plain, plain_seed = torch.Generator, torch.manual_seed
    torch.Generator = _OffsetGenerator
    torch.manual_seed = lambda seed: plain_seed(
        seed + _OffsetGenerator.offset)
    try:
        for name in names or sorted(BANDS):
            values = []
            for offset in OFFSETS:
                _OffsetGenerator.offset = offset
                values.append(as_json(run_example(name)))
            spread[name] = values
            print(name, values, flush=True)
            if BANDS[name][0] in ("seeds", "loose"):
                _OffsetGenerator.offset = 0
                nulls[name] = untrained(name, run_example, as_json)
                print(name, "untrained", nulls[name], flush=True)
    finally:
        torch.Generator, torch.manual_seed = plain, plain_seed
    _update(OUT, spread)
    _update(OUT_UNTRAINED, nulls)


if __name__ == "__main__":
    main(sys.argv[1:])
