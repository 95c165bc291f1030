"""launches_per_step.train: device operations (kernels, copies and sets)
in the traced window per optimizer step: the loop's and executor's
dispatch, which sets the pace where the host does."""
from perfbench.lib.readers import launches_per


def read(trace, cell):
    return launches_per(trace, "steps")
