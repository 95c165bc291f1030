"""Write ``tests/goldens/notebooks_spread.json``: what each port notebook
(``examples/torch/notebooks/``) prints when its code cells run at full
size on the CPU, for generator seeds offset by 0-7, and what it prints
with its iteration counts cut to one (a run that learned nothing).

Every ``torch.Generator`` the run makes (the package's default ones and
the cells' own) and torch's global generator are seeded with their seed
plus the offset, so each offset is another draw of the notebook's
random starts and Monte-Carlo samples; offset 0 is the run the tests
and the committed outputs make. ``tests/test_torch_notebooks_a.py``
holds a random printed value to the JAX notebook's within a multiple
of these runs' standard deviation, and keeps the cut runs' values
outside the band. Each notebook runs in a process of its own, on one
torch thread. Run from the repository root (a few minutes; Tier-1 does
not run it):

    python tests/oracles/torch_notebooks_spread.py [notebook ...]
"""
import json
import multiprocessing
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "goldens", "notebooks_spread.json")
OFFSETS = range(8)
COUNTS = re.compile(r"max_iter=\d+")


def spread(name):
    """``{"seeds": [output per offset], "probes": [probes per offset],
    "untrained": output}`` of the notebook ``name``."""
    sys.path.insert(0, ROOT)
    import torch
    from mxfusion_tpu_torch.common.config import set_default_device
    from tests.test_torch_notebooks_a import generate, load, probe_values
    set_default_device("cpu")
    torch.set_num_threads(1)
    offset = {"value": 0}
    plain, plain_seed = torch.Generator, torch.manual_seed

    class OffsetGenerator(plain):
        def manual_seed(self, seed):
            return super().manual_seed(seed + offset["value"])

    torch.Generator = OffsetGenerator
    torch.manual_seed = lambda seed: plain_seed(seed + offset["value"])

    def run(nb):
        torch.manual_seed(0)
        ns, outputs = generate.run_cells(nb, name)
        return "".join(outputs), probe_values(name, ns)

    nb = load(name)
    out = {"seeds": [], "probes": []}
    for k in OFFSETS:
        offset["value"] = k
        text, probes = run(nb)
        out["seeds"].append(text)
        out["probes"].append(probes)
    offset["value"] = 0
    for cell in nb["cells"]:
        if cell["cell_type"] == "code":
            cell["source"] = [COUNTS.sub("max_iter=1", line)
                              for line in cell["source"]]
    out["untrained"] = run(nb)[0]
    return name, out


def main(names):
    sys.path.insert(0, ROOT)
    from tests.test_torch_notebooks_a import NOTEBOOKS
    old = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            old = json.load(f)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(len(names or NOTEBOOKS), os.cpu_count())) as pool:
        for name, out in pool.imap_unordered(spread, names or NOTEBOOKS):
            old[name] = out
            print(name, out["untrained"], *out["seeds"], sep="\n",
                  flush=True)
    with open(OUT, "w") as f:
        json.dump({k: old[k] for k in NOTEBOOKS if k in old}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:])
