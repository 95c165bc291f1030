"""The port's notebooks on the CPU, held to the JAX notebooks' values
and to their committed outputs (the second of three files; the bands
and the runner are ``tests/test_torch_notebooks_a.py``'s)."""
import pytest

from tests.test_torch_notebooks_a import (_on_the_cpu,  # noqa: F401
                                          check_execution)

EXECUTED_HERE = ["deep_gp", "bnn_regression", "ppca_tutorial"]


@pytest.mark.parametrize("name", EXECUTED_HERE)
def test_notebook_lands_in_its_band(name):
    check_execution(name)
