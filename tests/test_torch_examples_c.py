"""The port's examples at ``MXF_SMOKE`` size on the CPU, held to the JAX
examples' values (the third of four files; the bands and the runner
are ``tests/test_torch_examples_a.py``'s)."""
import pytest

from tests.test_torch_examples_a import (_on_the_cpu, in_band,  # noqa: F401
                                         run_example)

SCRIPTS = ["matrix_completion.py", "lmc_multioutput.py",
           "writing_a_new_distribution.py", "ppca_tutorial.py",
           "hmc_regression.py", "deep_gp_regression.py",
           "deep_gp_classification.py"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_lands_in_its_band(name):
    in_band(name, run_example(name))
