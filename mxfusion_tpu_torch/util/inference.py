"""Shape realization and discovery utilities.

Counterpart of ``mxfusion_tpu/util/inference.py``. Symbolic dimensions
(Variables inside a shape tuple) are bound to python ints from the
observed data's shapes when inference is initialized;
``realize_shape`` resolves a shape tuple against the env, where shape
constants are stored as plain ints.
"""
from ..common.exceptions import ModelSpecificationError


def variables_to_UUID(variables):
    return [v.uuid if hasattr(v, "uuid") else v for v in variables]


def realize_shape(shape, env):
    """Resolve symbolic dims in ``shape`` to ints using ``env``
    ({uuid: value}; shape constants are python ints or 1-element
    arrays)."""
    rshape = []
    for s in shape:
        if isinstance(s, int):
            rshape.append(s)
        else:
            v = env[s.uuid]
            if hasattr(v, "ndim"):
                v = int(v.reshape(()))
            rshape.append(int(v))
    return tuple(rshape)


def discover_shape_constants(data_shapes, graphs):
    """Bind symbolic shape dims from observed data shapes.

    ``data_shapes``: {variable_uuid: concrete shape tuple}.
    Returns {shape_variable_uuid: int}. Raises on inconsistent bindings
    or mismatched ranks.
    """
    shape_constants = {}
    all_vars = {}
    for g in graphs:
        all_vars.update(g.variables)
    for uuid, concrete in data_shapes.items():
        if uuid not in all_vars:
            continue
        var = all_vars[uuid]
        label = var.name if var.name else uuid
        declared = var.shape
        if len(declared) != len(concrete):
            raise ModelSpecificationError(
                "Observed data for variable '{}' has rank {} but the "
                "variable was declared with rank {}.".format(
                    label, len(concrete), len(declared)))
        for d, c in zip(declared, concrete):
            if isinstance(d, int):
                if d != c:
                    raise ModelSpecificationError(
                        "Shape mismatch for variable '{}': declared {} "
                        "got {}.".format(label, declared, concrete))
            else:
                prev = shape_constants.get(d.uuid)
                if prev is not None and prev != c:
                    raise ModelSpecificationError(
                        "Inconsistent binding for symbolic dim {}: {} vs "
                        "{}.".format(d.uuid, prev, c))
                shape_constants[d.uuid] = int(c)
    return shape_constants


def init_outcomes(inference_outcomes):
    """Normalize carry-over inference results to a list."""
    if isinstance(inference_outcomes, (list, tuple)):
        return list(inference_outcomes)
    return [inference_outcomes]
