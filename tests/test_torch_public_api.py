"""The port's public surface: ``tests/test_public_api.py``'s ``SURFACE``
(the JAX package's documented names) mapped onto
``mxfusion_tpu_torch``. Every namespace and name imports from the port,
but those that ``NOT_YET`` names with the queue item that ports them,
and those that ``DIFFERS`` names with how the port's differs from the
JAX package's. ``FlaxFunction``'s counterpart is ``NNFunction``."""
import importlib

import pytest

from tests.test_public_api import SURFACE

RENAMED = {"FlaxFunction": "NNFunction"}

# namespace (or "namespace:name") -> the ROADMAP queue item that ports it
NOT_YET = {
    "mxfusion_tpu_torch.parallel": "A13",
    "mxfusion_tpu_torch.util.profiling": "A13",
}

# "namespace:name" -> how the port's object of that name differs from the
# JAX package's; such a name does not count as ported
DIFFERS = {
    "mxfusion_tpu_torch.ops:batched_cholesky":
        "the JAX package's is the function; the port's is the module of "
        "that name, whose batched_cholesky is the function (ROADMAP A2)",
}

# names the port exports beyond the documented surface, kept public
EXTRA = {
    "mxfusion_tpu_torch.ops": ["make_diagonal", "broadcast_to_w_samples",
                               "cholesky_logdet"],
    "mxfusion_tpu_torch.ops.scan": ["associative_scan"],
    "mxfusion_tpu_torch.ops.kalman": ["lgssm_path"],
    "mxfusion_tpu_torch.util": ["special", "CheckpointCallback",
                                "save_params", "load_params"],
}


def port_surface():
    out = {}
    for name, symbols in SURFACE.items():
        port = name.replace("mxfusion_tpu", "mxfusion_tpu_torch", 1)
        out[port] = [RENAMED.get(s, s) for s in symbols]
    for name, symbols in EXTRA.items():
        out[name] = out.get(name, []) + symbols
    return out


PORT_SURFACE = port_surface()


@pytest.mark.parametrize("module_name", sorted(
    n for n in PORT_SURFACE if n not in NOT_YET))
def test_port_namespace_surface(module_name):
    mod = importlib.import_module(module_name)
    missing = [s for s in PORT_SURFACE[module_name]
               if "{}:{}".format(module_name, s) not in NOT_YET
               and not hasattr(mod, s)]
    assert not missing, "{} lacks {}".format(module_name, missing)


@pytest.mark.parametrize("entry", sorted(NOT_YET))
def test_not_yet_entries_are_still_missing(entry):
    """A ``NOT_YET`` entry names a documented namespace or name the port
    does not have yet; once ported, it must leave the dict."""
    module_name, _, symbol = entry.partition(":")
    assert module_name in PORT_SURFACE
    if symbol:
        assert symbol in PORT_SURFACE[module_name]
        mod = importlib.import_module(module_name)
        assert not hasattr(mod, symbol)
    else:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(module_name)


def test_port_batched_cholesky_entry():
    """The one ``DIFFERS`` entry differs as it says: JAX's
    ``ops.batched_cholesky`` is called, the port's holds the callable."""
    import types

    from mxfusion_tpu import ops as jops
    from mxfusion_tpu_torch import ops
    assert sorted(DIFFERS) == ["mxfusion_tpu_torch.ops:batched_cholesky"]
    assert callable(jops.batched_cholesky)
    assert isinstance(ops.batched_cholesky, types.ModuleType)
    assert not callable(ops.batched_cholesky)
    assert callable(ops.batched_cholesky.batched_cholesky)
