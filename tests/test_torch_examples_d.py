"""The port's examples at ``MXF_SMOKE`` size on the CPU, held to the JAX
examples' values (the last of four files; the bands and the runner are
``tests/test_torch_examples_a.py``'s), and, marked ``slow``, every JAX
example run beside its port in one process, the port's value held to
the JAX value of that run."""
import os
import runpy

import pytest

from tests.test_torch_examples_a import (BANDS, ROOT, SIZES,  # noqa: F401
                                         _on_the_cpu, as_json, in_band,
                                         run_example)

SCRIPTS = ["sgld_bnn_minibatch.py", "gmm_mixture.py",
           "svgp_natural_gradient.py", "svgp_large_scale.py",
           "data_parallel_svi.py", "svgp_poisson_counts.py"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_lands_in_its_band(name):
    in_band(name, run_example(name))


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(BANDS))
def test_jax_example_and_its_port_side_by_side(name, monkeypatch):
    """The JAX example now (float64 enabled and 8 virtual devices, by
    ``tests/conftest.py``), then the port's, in the same band."""
    from mxfusion_tpu.common import config as jconfig
    monkeypatch.setenv("MXF_SMOKE", "1")
    jdtype = jconfig.get_default_dtype()
    try:
        ns = runpy.run_path(os.path.join(ROOT, "examples", name),
                            run_name="example")
        ns["main"].__globals__.update(SIZES.get(name, {}))
        want = as_json(ns["main"]())
    finally:
        jconfig.set_default_dtype(jdtype)
    in_band(name, run_example(name), golden=want)
