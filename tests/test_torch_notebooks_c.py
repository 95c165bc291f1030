"""The port's notebooks on the CPU, held to the JAX notebooks' values
and to their committed outputs (the third of three files; the bands
and the runner are ``tests/test_torch_notebooks_a.py``'s), and the
deterministic notebooks held to JAX's at rtol 1e-10 in float64."""
import numpy as np
import pytest

from mxfusion_tpu_torch.common import config as tconfig

from tests.test_torch_notebooks_a import (EXECUTED_HERE as A,  # noqa: F401
                                          F64_PROBES, JAX_DIR, NOTEBOOKS,
                                          PROBES, _on_the_cpu,
                                          check_execution, generate, load,
                                          probe_values)
from tests.test_torch_notebooks_b import EXECUTED_HERE as B
from tests.test_torch_svgp_training import jax_f64

EXECUTED_HERE = ["variational_auto_encoder", "bnn_classification"]


def test_the_three_files_execute_every_notebook_once():
    assert sorted(A + B + EXECUTED_HERE) == sorted(NOTEBOOKS)


@pytest.mark.parametrize("name", EXECUTED_HERE)
def test_notebook_lands_in_its_band(name):
    check_execution(name)


@pytest.mark.parametrize("name", sorted(PROBES))
def test_deterministic_notebook_matches_jax_in_float64(name):
    """Both notebooks' cells in float64, the port's and JAX's, on the
    same data and starts: the fit's parameters and the printed error at
    rtol 1e-10."""
    both = {k: {**PROBES.get(k, {}), **F64_PROBES.get(k, {})}
            for k in PROBES}
    old = tconfig.get_default_dtype()
    tconfig.set_default_dtype("float64")
    try:
        ours = probe_values(name, generate.run_cells(load(name), name)[0],
                            both)
    finally:
        tconfig.set_default_dtype(old)
    with jax_f64():
        theirs = probe_values(
            name, generate.run_cells(load(name, JAX_DIR), name)[0], both)
    assert ours.keys() == theirs.keys() == both[name].keys()
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-10,
                                   err_msg=(name, k))
