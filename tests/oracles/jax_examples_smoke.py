"""Write ``tests/goldens/examples_smoke_jax.json``: the return value of
every JAX example's ``main()`` at ``MXF_SMOKE`` size, with the raised
counts of ``SIZES`` in ``tests/test_torch_examples_a.py``.

The port's examples (``examples/torch/``) are held to these values by
``tests/test_torch_examples_*.py``. The examples run as the JAX
package's own example tests run them (``tests/conftest.py``): on the
CPU, over 8 virtual devices, with float64 enabled. Run from the
repository root:

    python tests/oracles/jax_examples_smoke.py [script ...]

With script names (``gp_regression.py``, ``pilco/pilco_example.py``)
only those entries are rewritten. With ``--full`` first, the named
scripts run at full size and their values are printed, not stored.
Tier-1 does not run this script.
"""
import json
import os
import runpy
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "goldens", "examples_smoke_jax.json")

# the JAX package's example list (tests/examples/test_examples.py)
EXAMPLES = [
    "getting_started.py", "ppca_tutorial.py", "bnn_regression.py",
    "bnn_classification.py", "gp_regression.py", "svgp_regression.py",
    "variational_auto_encoder.py", "writing_a_new_distribution.py",
    "pilco/pilco_example.py", "data_parallel_svi.py",
    "svgp_large_scale.py", "hmc_regression.py", "svgp_natural_gradient.py",
    "sgld_bnn_minibatch.py", "svgp_classification.py", "gmm_mixture.py",
    "model_comparison.py", "writing_a_new_module.py", "svgp_multiclass.py",
    "lmc_multioutput.py", "matrix_completion.py",
    "state_space_timeseries.py", "parallel_tempering.py",
    "stochastic_volatility.py", "svgp_poisson_counts.py",
    "deep_gp_regression.py", "deep_gp_classification.py",
]


def as_json(value):
    """A return value as JSON: numbers as floats, arrays and tuples as
    lists, strings and None as they are."""
    import numpy as np
    if value is None or isinstance(value, str):
        return value
    if isinstance(value, (tuple, list)):
        return [as_json(v) for v in value]
    a = np.asarray(value)
    return float(a) if a.ndim == 0 else a.astype(float).tolist()


def main(names, full=False):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    if full:
        os.environ.pop("MXF_SMOKE", None)
    else:
        os.environ["MXF_SMOKE"] = "1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    from tests.test_torch_examples_a import SIZES
    golden = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            golden = json.load(f)
    for name in names or EXAMPLES:
        t0 = time.perf_counter()
        ns = runpy.run_path(os.path.join(ROOT, "examples", name),
                            run_name="example")
        if not full:
            ns["main"].__globals__.update(SIZES.get(name, {}))
        golden[name] = as_json(ns["main"]())
        print(name, "at full size" if full else "", golden[name],
              "{:.1f} s".format(time.perf_counter() - t0), flush=True)
    if full:
        return
    with open(OUT, "w") as f:
        json.dump({k: golden[k] for k in EXAMPLES if k in golden}, f,
                  indent=1)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--full"]:
        main(sys.argv[2:], full=True)
    else:
        main(sys.argv[1:])
