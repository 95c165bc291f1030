"""The port's examples (``examples/torch/``) at ``MXF_SMOKE`` size on the
CPU, each return value held to the JAX example's at the same size.

The JAX values are ``tests/goldens/examples_smoke_jax.json``, written by
``tests/oracles/jax_examples_smoke.py`` (not run by Tier-1). Each
script runs through ``runpy`` after ``set_default_device("cpu")``, with
torch on one thread, and its ``main()`` is called; the scripts are
split over ``tests/test_torch_examples_{a,b,c,d}.py`` so that xdist's
``--dist loadfile`` spreads them over the workers. ``BANDS`` states how
close each value must be and why: 1e-4 relative where the run is
deterministic given its data; elsewhere the two packages start from
other random values (q's means, covariance factors and inducing outputs
are uniform(-0.07, 0.07) draws of each framework's generator, networks
take their initial weights from each framework's) and draw other
Monte-Carlo samples, and the band is a multiple of the value's
seed-to-seed spread, narrowed so that a run that learned nothing lies
outside it. ``chip_smoke.py`` phase 56 holds the scripts' runs on the
card to the same bands."""
import json
import os
import runpy

import numpy as np
import pytest
import torch

from mxfusion_tpu_torch.common import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples", "torch")


def _golden(name):
    with open(os.path.join(ROOT, "tests", "goldens", name)) as f:
        return json.load(f)


GOLDEN = _golden("examples_smoke_jax.json")
SPREAD = _golden("examples_smoke_spread.json")
UNTRAINED = _golden("examples_smoke_untrained.json")

# A script whose every start is stated and that draws nothing (full-batch
# MAP, a deterministic rollout) gives JAX's value up to float32 rounding.
DETERMINISTIC = ("rtol", 1e-4)
# Elsewhere the packages start from other random values and draw other
# samples, so the port's value is another draw of the same estimate as
# JAX's. Its seed-to-seed spread is the sample standard deviation s of
# the port's runs on 8 generator seeds (``SPREAD``, written by
# ``tests/oracles/torch_examples_spread.py``); JAX's value must lie
# within SPREAD_K * s of the port's, with a floor where the value is
# quantized (an accuracy on 90-200 labels: two or three labels).
RANDOM = ("seeds", 0.0)
ACCURACY = ("seeds", 0.025)
SPREAD_K = 5.0   # 3.5 sd of the difference of two runs (s * sqrt(2))
# ... and never wider than UNTRAINED_SHARE of the distance from JAX's
# value to the nearest value of a run that learned nothing
# (``UNTRAINED``: the script with its iteration and sample counts cut to
# one or two, and, where the value is an error against a known truth, a
# predictor of zeros or of the column means), so such a run misses the
# band by a quarter of that distance at least. Half would fail a working
# port's runs on other draws: bnn_regression's spread from 0.26 to 0.45
# around JAX's 0.29, where a predictor of zeros scores 0.64.
UNTRAINED_SHARE = 0.75
# sgld_bnn_minibatch.py's chains barely leave their starts (step 5e-5,
# 200 steps at smoke size): chains that never move score 1.61, inside
# the port's seeds' 1.13-2.85 and below JAX's 2.08, so its value cannot
# tell a working sampler from a frozen one, and it is held only to its
# seed spread capped at half the value. The sampler itself is held to
# JAX's in tests/test_torch_sgld_svgd_tempering.py.
LOOSE = ("loose", 0.5)
BANDS = {
    "getting_started.py": RANDOM,
    "ppca_tutorial.py": RANDOM,
    "bnn_regression.py": RANDOM,
    "bnn_classification.py": ACCURACY,
    "gp_regression.py": DETERMINISTIC,
    "svgp_regression.py": RANDOM,
    "variational_auto_encoder.py": RANDOM,
    "writing_a_new_distribution.py": DETERMINISTIC,
    "pilco/pilco_example.py": DETERMINISTIC,
    "data_parallel_svi.py": RANDOM,
    # returns None; its own asserts (the loss falls, mesh serving equals
    # the direct prediction) run inside main()
    "svgp_large_scale.py": ("equal", None),
    "hmc_regression.py": RANDOM,
    "svgp_natural_gradient.py": RANDOM,
    "sgld_bnn_minibatch.py": LOOSE,
    "svgp_classification.py": ACCURACY,
    "gmm_mixture.py": DETERMINISTIC,
    "model_comparison.py": ("equal", None),   # the preferred model
    "writing_a_new_module.py": DETERMINISTIC,
    "svgp_multiclass.py": ACCURACY,
    "lmc_multioutput.py": RANDOM,
    "matrix_completion.py": RANDOM,
    "state_space_timeseries.py": DETERMINISTIC,
    "parallel_tempering.py": RANDOM,
    "stochastic_volatility.py": RANDOM,
    "svgp_poisson_counts.py": RANDOM,
    "deep_gp_regression.py": RANDOM,
    "deep_gp_classification.py": ACCURACY,
}
# Counts raised above MXF_SMOKE's where a working port's runs at smoke
# size fall on both sides of an untrained run's value (the BNN's 50 SVI
# steps, the SVGP's 10 minibatch steps, the VAE's 40, the matrix
# factorization's 50): every value above, the JAX one, the spread and
# the untrained ones, is taken at these counts (MAX_ITER 800 is the
# BNN's full size).
SIZES = {
    "bnn_regression.py": {"MAX_ITER": 800},
    "svgp_regression.py": {"EPOCHS": 60},
    "variational_auto_encoder.py": {"MAX_ITER": 200},
    "matrix_completion.py": {"MAX_ITER": 300},
}


def seed_tolerance(name):
    """The band's half-width for each component of ``name``'s value:
    SPREAD_K times the port's seed-to-seed standard deviation, at least
    the band's floor, at most UNTRAINED_SHARE of the way to the nearest
    untrained value (LOOSE: to half the value)."""
    kind, floor = BANDS[name]
    s = np.asarray(SPREAD[name], dtype=float).std(axis=0, ddof=1)
    tol = np.maximum(SPREAD_K * s, floor)
    want = np.asarray(GOLDEN[name], dtype=float)
    if kind == "loose":
        return np.minimum(tol, floor * np.abs(want))
    gap = np.min([np.abs(want - np.asarray(v, dtype=float))
                  for v in UNTRAINED[name]], axis=0)
    return np.minimum(tol, UNTRAINED_SHARE * gap)


def as_json(value):
    """A return value as the golden stores it."""
    if value is None or isinstance(value, str):
        return value
    if isinstance(value, (tuple, list)):
        return [as_json(v) for v in value]
    a = np.asarray(value)
    return float(a) if a.ndim == 0 else a.astype(float).tolist()


def in_band(name, value, golden=None):
    """Raise unless ``value`` lies in the band of ``name`` around the JAX
    value (``golden``, default the stored one)."""
    kind, tol = BANDS[name]
    want = GOLDEN[name] if golden is None else golden
    got = as_json(value)
    if kind == "equal":
        assert got == want, (name, got, want)
        return
    got_a, want_a = np.atleast_1d(got), np.atleast_1d(want)
    assert got_a.shape == want_a.shape and np.isfinite(got_a).all(), \
        (name, got, want)
    if kind == "rtol":
        np.testing.assert_allclose(got_a, want_a, rtol=tol, err_msg=name)
    else:
        tol = np.atleast_1d(seed_tolerance(name))
        assert (np.abs(got_a - want_a) <= tol).all(), \
            (name, got, want, tol)


def run_example(name, smoke=True, sizes=None):
    """Run ``examples/torch/<name>`` and return its ``main()``'s value:
    at ``MXF_SMOKE`` size with the counts of ``SIZES`` (``sizes``, when
    given, in their place), or at full size."""
    old = os.environ.get("MXF_SMOKE")
    if smoke:
        os.environ["MXF_SMOKE"] = "1"
    else:
        os.environ.pop("MXF_SMOKE", None)
    try:
        ns = runpy.run_path(os.path.join(EXAMPLES, name),
                            run_name="example")
        if smoke:
            ns["main"].__globals__.update(
                SIZES.get(name, {}) if sizes is None else sizes)
        return ns["main"]()
    finally:
        if old is None:
            os.environ.pop("MXF_SMOKE", None)
        else:
            os.environ["MXF_SMOKE"] = old


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The CPU, on one torch thread (loops of small ops; several xdist
    workers share the cores); the old settings afterwards."""
    old = tconfig.set_default_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tconfig.set_default_device(old)


def test_deterministic_examples_ignore_the_seed():
    """The scripts held at 1e-4 drew nothing: their 8 seeds' runs gave
    one value; the random ones' runs spread, so their bands are not
    empty."""
    for name, band in BANDS.items():
        values = SPREAD[name]
        assert len(values) == 8, name
        if band == DETERMINISTIC or band[0] == "equal":
            assert all(v == values[0] for v in values), name
        elif band == RANDOM:
            assert (seed_tolerance(name) > 0).all(), name


SEEDED = sorted(n for n, b in BANDS.items() if b[0] in ("seeds", "loose"))


@pytest.mark.parametrize("name", SEEDED)
def test_each_seed_of_the_port_lands_in_the_band(name):
    """The band holds every one of the port's 8 seeded runs, so a
    working port's run on other draws (the card's) lands in it too."""
    for value in SPREAD[name]:
        in_band(name, value)


@pytest.mark.parametrize(
    "name", [n for n in SEEDED if BANDS[n][0] == "seeds"])
def test_an_untrained_run_falls_outside_the_band(name):
    """A run that learned nothing, and a predictor of zeros or column
    means where the value is an error against a truth, fail the band."""
    assert UNTRAINED[name]
    for value in UNTRAINED[name]:
        with pytest.raises(AssertionError):
            in_band(name, value)


def test_every_example_has_a_port_and_a_band():
    jax_examples = sorted(
        os.path.relpath(os.path.join(d, f), os.path.join(ROOT, "examples"))
        for d, _, fs in os.walk(os.path.join(ROOT, "examples"))
        for f in fs if f.endswith(".py")
        and "torch" not in os.path.relpath(d, ROOT).split(os.sep)
        and "notebooks" not in os.path.relpath(d, ROOT).split(os.sep))
    assert len(jax_examples) == 27
    assert sorted(GOLDEN) == sorted(BANDS) == sorted(SPREAD) == \
        jax_examples
    assert sorted(UNTRAINED) == SEEDED
    for name in jax_examples:
        assert os.path.exists(os.path.join(EXAMPLES, name)), name


SCRIPTS = ["model_comparison.py", "writing_a_new_module.py",
           "getting_started.py", "gp_regression.py", "svgp_regression.py",
           "svgp_classification.py", "svgp_multiclass.py"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_lands_in_its_band(name):
    in_band(name, run_example(name))
