"""Write ``tests/goldens/notebooks_jax.json``: what the JAX package's
notebooks (``examples/notebooks/*.ipynb``) print when their code cells
run, and the full-precision values of their deterministic fits.

The port's notebooks (``examples/torch/notebooks/``) are held to these
values by ``tests/test_torch_notebooks_*.py``. The cells run as
``examples/notebooks/generate.py --execute`` runs them: one namespace
per notebook, JAX on the CPU platform, float32, in order; the notebooks
are read and never written. Each execution's printed numbers are then
checked against the outputs committed in the notebook, to their printed
digits. Run from the repository root (a few minutes; Tier-1 does not
run it):

    python tests/oracles/jax_notebooks.py [notebook ...]

With notebook names (``gp_regression``) only those entries are
rewritten. The script exits 1 if an execution disagrees with its
committed outputs.
"""
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "goldens", "notebooks_jax.json")


def run_jax_notebook(name):
    """The code cells' captured outputs, their committed outputs and the
    values of the notebook's probes over the final namespace."""
    from tests.test_torch_notebooks_a import probe_values
    with open(os.path.join(ROOT, "examples", "notebooks",
                           name + ".ipynb")) as f:
        nb = json.load(f)
    ns = {"__name__": "__notebook__"}
    outputs, committed = [], []
    for i, cell in enumerate(c for c in nb["cells"]
                             if c["cell_type"] == "code"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            exec(compile("".join(cell["source"]), "{}[{}]".format(name, i),
                         "exec"), ns)
        outputs.append(buf.getvalue())
        committed.append("".join(
            "".join(o.get("text", "")) for o in cell["outputs"]))
    return outputs, committed, probe_values(name, ns)


def main(names):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from tests.test_torch_notebooks_a import (NOTEBOOKS,
                                              same_to_printed_digits)
    golden = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            golden = json.load(f)
    bad = []
    for name in names or NOTEBOOKS:
        t0 = time.perf_counter()
        outputs, committed, probes = run_jax_notebook(name)
        agree = same_to_printed_digits("".join(outputs),
                                       "".join(committed))
        if not agree:
            bad.append(name)
        golden[name] = {"outputs": outputs, "probes": probes}
        print(name, "".join(outputs), probes,
              "agrees with the committed outputs" if agree else
              "DIFFERS from the committed outputs: " + "".join(committed),
              "{:.1f} s".format(time.perf_counter() - t0), flush=True)
    with open(OUT, "w") as f:
        json.dump({k: golden[k] for k in NOTEBOOKS if k in golden}, f,
                  indent=1)
        f.write("\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
