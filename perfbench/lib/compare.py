"""The numbers that decide ``correct``, each held against its limit.

Training (the first ``check_steps`` optimizer steps of the timed call,
against the plain reference from the same start on the same rows):

- ``loss_gap``: the widest gap of a step's loss, in nats a data row (the
  losses are the negative bound scaled to all N rows, and pass near 0
  in training, so a gap relative to the loss would swing with it);
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer got it (worked out from Adam's first moment
  after one step) and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``grad_gap_median``: the median over the leaves that move (below) of
  the same per-leaf gap: steady from seed to seed where the worst leaf
  is a scalar whose gradient is a cancelling sum;
- ``step_gap``: the same as ``grad_gap`` of the parameters' change after
  the checked steps. Leaves whose reference gradient is under a
  thousandth of the median leaf's move under Adam by round-off alone and
  are left out.

A cell's ``limits`` name the numbers it compares.

Serving (every row of a seeded sample of the window's requests, the
longest among them):

- ``mean_gap``: the widest gap of a predictive mean over the largest
  reference mean in magnitude;
- ``var_gap``: the same of the predictive variances.
"""
import math
import statistics

# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam
ZERO_GRAD_SHARE = 1e-3


def norms(leaves):
    """{name: Euclidean norm} of a dict of tensors, as floats."""
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gaps(got, want, names=None):
    """{leaf: |got - want| / max(want, median of want)} over ``names``
    (default: every leaf) of two dicts of norms."""
    names = sorted(want) if names is None else names
    median = statistics.median(want[k] for k in sorted(want))
    return {k: abs(got[k] - want[k]) / max(want[k], median) for k in names}


def worst_leaf_gap(got, want, names=None):
    """The worst leaf's gap of two dicts of norms (:func:`leaf_gaps`)."""
    return max(leaf_gaps(got, want, names).values(), default=0.0)


def training_numbers(program, reference, rows):
    """``program`` and ``reference``: dicts with ``losses`` (floats, one a
    checked step), ``grad_norms`` ({leaf: norm of the first gradient}) and
    ``change_norms`` ({leaf: norm of the change after the checked
    steps}); ``rows``: the N the losses are scaled to. Returns {name:
    value}."""
    losses = [abs(a - b) / rows for a, b in
              zip(program["losses"], reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]):
        losses.append(math.inf)
    grads = reference["grad_norms"]
    median = statistics.median(grads.values())
    moved = [k for k in sorted(grads) if grads[k] >= ZERO_GRAD_SHARE * median]
    return {
        "loss_gap": max(losses),
        "grad_gap": worst_leaf_gap(program["grad_norms"], grads),
        "grad_gap_median": statistics.median(
            leaf_gaps(program["grad_norms"], grads, moved).values()),
        "step_gap": worst_leaf_gap(program["change_norms"],
                                   reference["change_norms"], moved),
    }


def serving_numbers(pairs):
    """``pairs``: [(program (mean, var), reference (mean, var))] of numpy
    arrays, one pair a compared request. Returns {name: value}."""
    import numpy as np
    mean_gap = var_gap = 0.0
    mean_scale = var_scale = 0.0
    for (pm, pv), (rm, rv) in pairs:
        mean_gap = max(mean_gap, float(np.max(np.abs(pm - rm))))
        var_gap = max(var_gap, float(np.max(np.abs(pv - rv))))
        mean_scale = max(mean_scale, float(np.max(np.abs(rm))))
        var_scale = max(var_scale, float(np.max(np.abs(rv))))
    return {"mean_gap": mean_gap / mean_scale, "var_gap": var_gap / var_scale}


def judge(numbers, limits):
    """(correct, checks): each number beside its limit; a number that is
    not finite or above its limit, or a limit with no number, fails."""
    checks = {}
    correct = True
    for name in sorted(limits):
        value = numbers.get(name, math.nan)
        ok = math.isfinite(value) and value <= limits[name]
        correct = correct and ok
        checks[name] = {"value": value, "limit": limits[name]}
    return correct, checks
