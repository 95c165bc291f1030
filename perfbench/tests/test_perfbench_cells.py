"""Each cell end to end on the CPU at a tiny size: the harness drives the
port's timed path, and the plain reference agrees with it; with each
fault the cell can have planted under the timed path, and with the
control in the program's place, ``correct`` comes out false."""
import time

import pytest
import torch

from perfbench import calibrate
from perfbench.lib import harness
from perfbench.tests.tiny import CELLS, TINY, TRAINING

# float32 on the CPU: the reference and the port round alike up to the
# order of their sums, far inside every limit
AGREE = 1e-4
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_run_agrees_with_reference(cell, trace):
    result = harness.run_cell(cell, SEED, 0.5, trace, time.perf_counter(),
                              device="cpu", overrides=TINY[cell],
                              log=lambda *a: None)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= AGREE for c in result["checks"].values()), \
        result["checks"]
    if not trace:
        assert result["metrics"]["setup_s"]["value"] > 0


FAULTS = [(c, "unchanged_state") for c in TRAINING] + \
    [(c, "half_batch") for c in TRAINING] + [("svgp.serve", "altered_answer")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    r = calibrate.reading(cell, SEED, 0.5, "cpu", fault=fault,
                          overrides=TINY[cell])
    correct, _ = harness.compare.judge(r["numbers"],
                                       harness.workload(cell)["limits"])
    assert not correct, r["numbers"]


@pytest.mark.parametrize("cell", TRAINING)
def test_control_is_not_correct(cell):
    r = calibrate.reading(cell, SEED, 0.5, "cpu",
                          control=harness.workload(cell)["control"],
                          overrides=TINY[cell])
    correct, _ = harness.compare.judge(r["numbers"],
                                       harness.workload(cell)["limits"])
    assert not correct, r["numbers"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the serving control computes in TF32, which only a "
                    "CUDA card has")


@pytest.mark.cuda
def test_serve_control_is_not_correct(card):
    cell = "svgp.serve"
    r = calibrate.reading(cell, SEED, 2.0, "cuda",
                          control=harness.workload(cell)["control"])
    correct, _ = harness.compare.judge(r["numbers"],
                                       harness.workload(cell)["limits"])
    assert not correct, r["numbers"]
