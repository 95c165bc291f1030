"""The port's examples at ``MXF_SMOKE`` size on the CPU, held to the JAX
examples' values (the second of four files; the bands and the runner
are ``tests/test_torch_examples_a.py``'s)."""
import pytest

from tests.test_torch_examples_a import (_on_the_cpu, in_band,  # noqa: F401
                                         run_example)

SCRIPTS = ["parallel_tempering.py", "state_space_timeseries.py",
           "variational_auto_encoder.py", "stochastic_volatility.py",
           "pilco/pilco_example.py", "bnn_regression.py",
           "bnn_classification.py"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_lands_in_its_band(name):
    in_band(name, run_example(name))
