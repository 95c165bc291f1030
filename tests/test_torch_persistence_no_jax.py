"""Persistence without JAX: in a fresh interpreter in which ``import jax``
fails, the port trains a small SVGP under ``CheckpointCallback``, resumes
from the snapshot, saves the inference, rebuilds the model in code,
loads it and exports a predictor; a second interpreter that builds no
model serves the artifact. Neither process holds ``jax`` or
``mxfusion_tpu`` in ``sys.modules``, and the served answer equals the
first process's live predictor."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

HEADER = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
from mxfusion_tpu_torch.common import config
config.set_default_device("cpu")


def no_jax():
    held = [k for k in sys.modules if k.split(".")[0] in
            ("jax", "jaxlib", "mxfusion_tpu") and sys.modules[k] is not None]
    assert not held, held
"""

TRAIN_SAVE_EXPORT = HEADER + r"""
from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.inference import (BatchedPredictor,
                                          GradBasedInference, MAP)
from mxfusion_tpu_torch.util import CheckpointCallback, load_params

N, M, D = 120, 8, 2
rng = np.random.default_rng(0)
X = rng.uniform(0, 4, (N, D))
Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
Z0 = rng.uniform(0, 4, (M, D))


def build():
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D), noise_var=m.noise_var,
        shape=(m.n, 1), inducing_inputs=Variable(shape=(M, D),
                                                 initial_value=Z0))
    return m, GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                                 dtype="float64")


m, inf = build()
losses = []
inf.run(X=X, Y=Y, max_iter=10, learning_rate=0.05,
        callback=lambda i, l: losses.append(float(l)))
m_c, inf_c = build()
inf_c.run(X=X, Y=Y, max_iter=6, learning_rate=0.05,
          callback=CheckpointCallback(inf_c.params, {ckpt!r}, every=5))
state = load_params(inf_c.params, {ckpt!r})
assert state.step == 5, state.step
resumed = []
inf_c.run(X=X, Y=Y, max_iter=10, learning_rate=0.05, resume_state=state,
          callback=lambda i, l: resumed.append(float(l)))
assert np.allclose(resumed, losses[5:], rtol=0, atol=1e-12), (resumed,
                                                                losses)
inf_c.save({zip!r})
m2, inf2 = build()
inf2.initialize(X=X, Y=Y)
inf2.load({zip!r})
Xt = rng.uniform(0, 4, (70, D))
live = BatchedPredictor(model=m, infr_params=inf.params, observed=[m.X],
                        target_variables=[m.Y.uuid], chunk_size=32)
want = live.predict(X=Xt)[0]
pred = BatchedPredictor(model=m2, infr_params=inf2.params, observed=[m2.X],
                        target_variables=[m2.Y.uuid], chunk_size=32)
got = pred.predict(X=Xt)[0]
for a, b in zip(got, want):
    assert np.allclose(a, b, rtol=1e-12, atol=1e-14)
pred.export({artifact!r})
np.save({xt!r}, Xt)
np.save({want!r}, np.stack(want))
no_jax()
print("EXPORTED")
"""

SERVE = HEADER + r"""
from mxfusion_tpu_torch.inference import load_exported_predictor

served = load_exported_predictor({artifact!r})
mu, var = served.predict(X=np.load({xt!r}))[0]
want = np.load({want!r})
assert np.allclose(mu, want[0], rtol=1e-12, atol=1e-14)
assert np.allclose(var, want[1], rtol=1e-12, atol=1e-14)
no_jax()
print("SERVED", float(mu.mean()))
"""


def run(script, **paths):
    proc = subprocess.run(
        [sys.executable, "-c", script.format(root=str(ROOT), **paths)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_train_checkpoint_save_load_export_and_serve_without_jax(tmp_path):
    paths = {k: str(tmp_path / v) for k, v in (
        ("ckpt", "run.npz"), ("zip", "svgp.zip"),
        ("artifact", "predictor.zip"), ("xt", "xt.npy"),
        ("want", "want.npy"))}
    assert "EXPORTED" in run(TRAIN_SAVE_EXPORT, **paths)
    assert "SERVED" in run(SERVE, **paths)
