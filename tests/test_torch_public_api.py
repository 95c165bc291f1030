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
NOT_YET = {}

# "namespace:name" -> how the port's object of that name differs from the
# JAX package's; such a name does not count as ported
DIFFERS = {}

# names the port exports beyond the documented surface, kept public
EXTRA = {
    "mxfusion_tpu_torch.ops": ["make_diagonal", "broadcast_to_w_samples",
                               "cholesky_logdet"],
    "mxfusion_tpu_torch.ops.scan": ["associative_scan"],
    "mxfusion_tpu_torch.ops.kalman": ["lgssm_path"],
    "mxfusion_tpu_torch.util": ["special", "CheckpointCallback",
                                "save_params", "load_params"],
    # jax.device_put, which places q(U) and Z over the model axis; it is
    # JAX's own and not in the JAX package's SURFACE
    "mxfusion_tpu_torch.parallel": ["device_put"],
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


# the namespaces NOT_YET named until they were ported (PR 16)
PORTED_FROM_NOT_YET = ["mxfusion_tpu_torch.parallel",
                       "mxfusion_tpu_torch.util.profiling"]


@pytest.mark.parametrize("entry", sorted(set(NOT_YET) |
                                         set(PORTED_FROM_NOT_YET)))
def test_not_yet_entries_are_still_missing(entry):
    """A ``NOT_YET`` entry names a documented namespace or name the port
    does not have yet; once ported, it leaves the dict and imports."""
    module_name, _, symbol = entry.partition(":")
    assert module_name in PORT_SURFACE
    if entry not in NOT_YET:
        mod = importlib.import_module(module_name)
        assert not symbol or hasattr(mod, symbol)
    elif symbol:
        assert symbol in PORT_SURFACE[module_name]
        mod = importlib.import_module(module_name)
        assert not hasattr(mod, symbol)
    else:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(module_name)


def test_port_batched_cholesky_entry():
    """``ops.batched_cholesky`` is the function in both packages, and it
    factors as JAX's does; the port's module of that name is reached by
    its full path."""
    import types

    import numpy as np
    import torch

    from mxfusion_tpu import ops as jops
    from mxfusion_tpu_torch import ops
    assert DIFFERS == {}
    assert callable(jops.batched_cholesky)
    assert callable(ops.batched_cholesky)
    assert not isinstance(ops.batched_cholesky, types.ModuleType)
    module = importlib.import_module(
        "mxfusion_tpu_torch.ops.batched_cholesky")
    assert isinstance(module, types.ModuleType)
    assert ops.batched_cholesky is module.batched_cholesky
    rng = np.random.default_rng(0)
    W = rng.standard_normal((3, 5, 5))
    A = W @ np.swapaxes(W, -1, -2) + 5 * np.eye(5)
    np.testing.assert_allclose(
        ops.batched_cholesky(torch.as_tensor(A)).numpy(),
        np.asarray(jops.batched_cholesky(A.astype(np.float32))),
        rtol=1e-5, atol=1e-5)
