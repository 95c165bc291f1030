"""The port's tutorial notebooks (``examples/torch/notebooks/``) on the
CPU, each held to the JAX notebook of the same name.

``examples/torch/notebooks/generate.py`` writes the 9 notebooks and,
with ``--execute``, runs them on the CPU and embeds their outputs. Here
each notebook is checked for its structure (valid nbformat 4.5, unique
cell ids, JAX's sequence of markdown headings, no code cell importing
JAX, flax or the JAX package, the cells ``generate.py`` writes), then
its code cells run at full size on the CPU on one torch thread, and
every number its cells print is held to the JAX notebook's
(``tests/goldens/notebooks_jax.json``, written by
``tests/oracles/jax_notebooks.py``, not run by Tier-1) and to the
outputs committed in the port's notebook. The executions are split
over ``tests/test_torch_notebooks_{a,b,c}.py`` so that xdist's
``--dist loadfile`` spreads them over the workers.

How close a printed number must be is its kind (``KINDS``): a number
of the data or of the text (``exact``) and a deterministic fit
(``det``: full-batch MAP with every start stated) within one unit of
its printed digit, the fit's full-precision values (``PROBES``) at
rtol 1e-4 (and in float64 at 1e-10, ``F64_PROBES`` too); a random
value within 5 of the port's seed-to-seed standard deviations
(``tests/goldens/notebooks_spread.json``, written by
``tests/oracles/torch_notebooks_spread.py`` over 8 generator seeds),
and, for a value that training moves (``seeds``, ``accuracy``), never
more than 3/4 of the way to the value of a run whose iteration counts
were cut to one, so that such a run fails (``spread``: a random value
that such a run does not move away from, a loss before the first step
or bnn_classification's last loss, whose untrained 58.9 lies below the
trained runs' 68-99, is held to the 5 sd alone; that notebook's
untrained run fails on its accuracy). ``chip_smoke.py`` phase 57
holds the notebooks' runs on the card to the same bands.
"""
import ast
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxfusion_tpu_torch.common import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "examples", "torch", "notebooks")
JAX_DIR = os.path.join(ROOT, "examples", "notebooks")

NOTEBOOKS = ["getting_started", "gp_regression", "svgp_regression",
             "ppca_tutorial", "bnn_regression", "bnn_classification",
             "variational_auto_encoder", "writing_a_new_distribution",
             "deep_gp"]

# the full-precision values of the deterministic fits: expressions over a
# notebook's final namespace, the same in either package
PROBES = {
    "gp_regression": {
        "lengthscale": "infr.params[kernel.lengthscale]",
        "variance": "infr.params[kernel.variance]",
        "noise": "infr.params[m.noise_var]",
    },
    "writing_a_new_distribution": {
        "location": "infr.params[m.loc]",
        "scale": "infr.params[m.scale]",
    },
}
# ... and in float64 (``tests/test_torch_notebooks_c.py``) the printed
# error too (``_np``: any array as numpy). In float32 it is a mean of
# |mu - sin(x)| whose rounding by the float32 Cholesky of a 60-point gram
# at noise 0.0096 differs between the packages by more than 1e-4 of it,
# so in float32 it is held to its printed digit.
F64_PROBES = {
    "gp_regression": {"error": "np.abs(_np(mu)[0] - np.sin(Xt)).mean()"},
}

SPREAD_K = 5.0          # sd of the port's values over 8 seeds
UNTRAINED_SHARE = 0.75  # of the way from JAX's value to an untrained run's
ACCURACY_FLOOR = 0.025  # an accuracy on 100 labels: two or three labels
PROBE_RTOL = 1e-4

START, TRAINED = ("exact", "spread"), ("exact", "seeds")
# for each notebook, each printed line's template (its numbers as "#")
# and the kinds of its numbers, by the line's occurrence (the last entry
# for the later ones)
KINDS = {
    "getting_started": {
        "Iteration # loss: #": [START, TRAINED],
        "posterior mean: # (data mean #)": [("seeds", "exact")],
        "noise variance: # (data var #)": [("seeds", "exact")],
        "predictive sample mean: #": [("seeds",)],
    },
    "gp_regression": {
        "lengthscale: #, variance: #, noise: #": [("det", "det", "det")],
        "predictive mean abs error vs sin(x): #": [("det",)],
    },
    "svgp_regression": {
        "predictive mean abs error vs sin(x): #": [("seeds",)],
    },
    "ppca_tutorial": {
        "loss: # -> #": [("spread", "seeds")],
        "mean reconstruction error: #": [("seeds",)],
    },
    "bnn_regression": {
        "loss: # -> #": [("spread", "seeds")],
        "posterior predictive mean abs error vs sin(x): #": [("seeds",)],
    },
    "bnn_classification": {
        "loss: # -> #": [("spread", "spread")],
        "train accuracy with posterior-mean weights: #": [("accuracy",)],
    },
    "variational_auto_encoder": {
        "ELBO loss: # -> #": [("spread", "seeds")],
    },
    "writing_a_new_distribution": {
        "MLE location: # (true #)": [("det", "exact")],
        "MLE scale:    # (true #)": [("det", "exact")],
    },
    "deep_gp": {
        "loss: # -> #": [("spread", "seeds")],
        "RMSE vs the noiseless step: #": [("seeds",)],
    },
}
RANDOM = [n for n in NOTEBOOKS if n not in PROBES]

NUMBER = re.compile(r"-?(?:nan|inf|\d+(?:\.\d*)?(?:[eE][-+]?\d+)?)")


def _golden(name):
    """A golden file; empty while an oracle writes it the first time."""
    path = os.path.join(ROOT, "tests", "goldens", name)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


GOLDEN = _golden("notebooks_jax.json")
SPREAD = _golden("notebooks_spread.json")


def to_numpy(x):
    """A torch tensor, JAX array or number as a float64 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=float)


def probe_values(name, ns, probes=PROBES):
    """``probes[name]`` evaluated over a notebook's final namespace."""
    scope = dict(ns, _np=to_numpy)
    return {k: float(to_numpy(eval(e, scope)).ravel()[0])
            for k, e in probes.get(name, {}).items()}


def printed(text):
    """``{key: number string}`` of every number in ``text``: the key is
    the line's template (its numbers as ``#``), the template's
    occurrence and the number's place in the line."""
    seen, out = {}, {}
    for line in text.splitlines():
        numbers = NUMBER.findall(line)
        if not numbers:
            continue
        template = NUMBER.sub("#", line)
        k = seen.get(template, 0)
        seen[template] = k + 1
        for i, s in enumerate(numbers):
            out[(template, k, i)] = s
    return out


def unit(s):
    """One unit in the last printed digit of the number string ``s``."""
    mantissa = re.split("[eE]", s)[0]
    decimals = len(mantissa.split(".")[1]) if "." in mantissa else 0
    exponent = int(re.split("[eE]", s)[1]) if re.search("[eE]", s) else 0
    return 10.0 ** (exponent - decimals)


def same_to_printed_digits(got, want):
    """Whether two captured outputs print the same lines and numbers
    that agree to their printed digits (a float32 repr to float32's
    six)."""
    a, b = printed(got), printed(want)
    if NUMBER.sub("#", got) != NUMBER.sub("#", want) or a.keys() != b.keys():
        return False
    return all(abs(float(a[k]) - float(b[k]))
               <= max(unit(b[k]), 1e-6 * abs(float(b[k]))) for k in a)


def kind(name, key):
    template, k, i = key
    per_line = KINDS[name][template]
    return per_line[min(k, len(per_line) - 1)][i]


def jax_values(name):
    return printed("".join(GOLDEN[name]["outputs"]))


def tolerance(name, key):
    """The band's half-width for the printed number ``key`` of ``name``."""
    want = jax_values(name)[key]
    how = kind(name, key)
    if how in ("exact", "det"):
        return unit(want)
    seeds = [float(printed(t)[key]) for t in SPREAD[name]["seeds"]]
    tol = SPREAD_K * np.std(seeds, ddof=1)
    if how == "accuracy":
        tol = max(tol, ACCURACY_FLOOR)
    untrained = printed(SPREAD[name]["untrained"])
    if how != "spread" and key in untrained:
        tol = min(tol, UNTRAINED_SHARE * abs(float(want)
                                             - float(untrained[key])))
    return tol


def in_band(name, text, probes=None):
    """Raise unless every number ``text`` prints lies in its band around
    the JAX notebook's, and ``probes`` (full-precision values of a
    deterministic fit) within PROBE_RTOL of JAX's. ``text`` may print a
    subset of JAX's lines (a run cut short); the caller checks that the
    lines are the same."""
    got, want = printed(text), jax_values(name)
    assert set(got) <= set(want), (name, set(got) - set(want))
    for key, s in got.items():
        value, tol = float(s), tolerance(name, key)
        assert np.isfinite(value), (name, key, s)
        assert abs(value - float(want[key])) <= tol, \
            (name, key, s, want[key], tol)
    for k, v in (probes or {}).items():
        np.testing.assert_allclose(v, GOLDEN[name]["probes"][k],
                                   rtol=PROBE_RTOL, err_msg=(name, k))


def _load_generate():
    spec = importlib.util.spec_from_file_location(
        "torch_notebooks_generate", os.path.join(PORT_DIR, "generate.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


generate = _load_generate()


def load(name, directory=PORT_DIR):
    with open(os.path.join(directory, name + ".ipynb")) as f:
        return json.load(f)


def committed_outputs(nb):
    return ["".join("".join(o.get("text", "")) for o in c["outputs"])
            for c in nb["cells"] if c["cell_type"] == "code"]


def execute(name):
    """Run the committed port notebook's code cells on the current
    default device: the captured outputs of its code cells and its
    probes' values."""
    torch.manual_seed(0)
    ns, outputs = generate.run_cells(load(name), name)
    return outputs, probe_values(name, ns)


def hold_to_jax(name, text, probes):
    """Raise unless ``text`` prints the JAX notebook's lines, each number
    in its band, and ``probes`` lie within PROBE_RTOL of JAX's."""
    assert NUMBER.sub("#", text) == NUMBER.sub(
        "#", "".join(GOLDEN[name]["outputs"])), (name, text)
    in_band(name, text, probes)


def check_execution(name):
    """Run ``name`` on the CPU and hold it to JAX's values and to its
    committed outputs."""
    outputs, probes = execute(name)
    hold_to_jax(name, "".join(outputs), probes)
    for got, want in zip(outputs, committed_outputs(load(name))):
        assert same_to_printed_digits(got, want), (name, got, want)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The CPU, on one torch thread (loops of small ops; several xdist
    workers share the cores), with torch's float32 default dtype, as in
    a notebook's fresh kernel (``tests/oracles/svgp_torch_oracle.py``,
    which other test files import, sets float64 for its whole process,
    and the networks' weights are made in the default dtype); the old
    settings afterwards."""
    old = tconfig.set_default_device("cpu")
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)
    tconfig.set_default_device(old)


# ---------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------

def test_the_port_has_the_notebooks_of_jax():
    def names(directory):
        return sorted(f[:-len(".ipynb")] for f in os.listdir(directory)
                      if f.endswith(".ipynb"))
    assert names(PORT_DIR) == names(JAX_DIR) == sorted(NOTEBOOKS)
    assert sorted(GOLDEN) == sorted(SPREAD) == sorted(KINDS) == \
        sorted(NOTEBOOKS)


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_is_valid_nbformat(name):
    import nbformat
    nb = nbformat.read(os.path.join(PORT_DIR, name + ".ipynb"),
                       as_version=nbformat.NO_CONVERT)
    assert (nb.nbformat, nb.nbformat_minor) == (4, 5)
    nbformat.validate(nb)
    ids = [c["id"] for c in nb.cells]
    assert len(ids) == len(set(ids))


def _headings(nb):
    return [line.rstrip().replace("mxfusion_tpu_torch", "mxfusion_tpu")
            for c in nb["cells"] if c["cell_type"] == "markdown"
            for line in "".join(c["source"]).splitlines()
            if line.startswith("#")]


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_headings_follow_the_jax_notebook(name):
    port, jax_nb = load(name), load(name, JAX_DIR)
    assert _headings(port) == _headings(jax_nb)
    first = "".join(next(c for c in port["cells"]
                         if c["cell_type"] == "markdown")["source"])
    assert generate.CPU_OUTPUTS.strip() in first


def imported_roots(source):
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_code_cells_import_no_jax(name):
    roots = set()
    for c in load(name)["cells"]:
        if c["cell_type"] == "code":
            roots |= imported_roots("".join(c["source"]))
    assert "mxfusion_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "mxfusion_tpu"}, roots


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    out = tmp_path_factory.mktemp("notebooks")
    proc = subprocess.run(
        [sys.executable, os.path.join(PORT_DIR, "generate.py"), "--out",
         str(out)], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return str(out)


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_generate_reproduces_the_committed_cells(regenerated, name):
    """``generate.py`` without ``--execute`` writes the committed cells:
    the same types, ids, sources and metadata, with no outputs."""
    fresh, committed = load(name, regenerated), load(name)
    assert fresh["metadata"] == committed["metadata"]
    assert len(fresh["cells"]) == len(committed["cells"])
    for a, b in zip(fresh["cells"], committed["cells"]):
        for field in ("cell_type", "id", "source", "metadata"):
            assert a[field] == b[field], (name, field, a[field], b[field])
        if a["cell_type"] == "code":
            assert a["outputs"] == [] and a["execution_count"] is None
            assert b["execution_count"] is not None


# ---------------------------------------------------------------------
# the bands
# ---------------------------------------------------------------------

def test_every_printed_number_has_a_kind():
    for name in NOTEBOOKS:
        for key in jax_values(name):
            assert kind(name, key) in ("exact", "det", "spread", "seeds",
                                       "accuracy"), (name, key)


def test_deterministic_notebooks_ignore_the_seed():
    """The fits held at one printed unit and rtol 1e-4 drew nothing: 8
    seeds printed one output and gave one set of probes; the random
    notebooks' bands are not empty."""
    for name in NOTEBOOKS:
        seeds = SPREAD[name]["seeds"]
        assert len(seeds) == 8, name
        if name in PROBES:
            assert all(s == seeds[0] for s in seeds), name
            assert all(p == SPREAD[name]["probes"][0]
                       for p in SPREAD[name]["probes"]), name
        else:
            for key in jax_values(name):
                if kind(name, key) in ("seeds", "spread", "accuracy"):
                    assert tolerance(name, key) > 0, (name, key)


@pytest.mark.parametrize("name", RANDOM)
def test_each_seed_of_the_port_lands_in_the_band(name):
    """The band holds every one of the port's 8 seeded runs, so a
    working port's run on other draws (the card's) lands in it too."""
    for text in SPREAD[name]["seeds"]:
        in_band(name, text)


@pytest.mark.parametrize("name", RANDOM)
def test_an_untrained_run_falls_outside_the_band(name):
    """The notebook with its iteration counts cut to one fails its band."""
    with pytest.raises(AssertionError):
        in_band(name, SPREAD[name]["untrained"])


# ---------------------------------------------------------------------
# execution on the CPU
# ---------------------------------------------------------------------

EXECUTED_HERE = ["getting_started", "gp_regression", "svgp_regression",
                 "writing_a_new_distribution"]


@pytest.mark.parametrize("name", EXECUTED_HERE)
def test_notebook_lands_in_its_band(name):
    check_execution(name)
