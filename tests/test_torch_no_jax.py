"""mxfusion_tpu_torch stands without JAX: a fresh interpreter in which
``import jax`` fails imports the port and serves the small slice from a
numpy state. Also: chip_smoke.py refuses to run without a GPU and
without the rest of the repository."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SERVE_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.inference import BatchedPredictor
from mxfusion_tpu_torch.util.carryover import carryover_params

M, D = 16, 3
rng = np.random.default_rng(0)
inv = PositiveTransformation().inverse_transform
m = Model()
m.n = Variable()
m.X = Variable(shape=(m.n, D))
m.noise_var = Variable(transformation=PositiveTransformation(),
                       initial_value=0.1)
m.Y = SVGPRegression.define_variable(
    X=m.X, kernel=RBF(input_dim=D), noise_var=m.noise_var, shape=(m.n, 1),
    inducing_inputs=Variable(shape=(M, D)))
state = {{"inducing_inputs": rng.uniform(0, 4, (M, D)),
          "noise_var": inv(np.full(1, 0.1)),
          "Y.rbf_lengthscale": inv(np.full(1, 2.0)),
          "Y.rbf_variance": inv(np.ones(1)),
          "Y.qU_mean": rng.standard_normal((M, 1)),
          "Y.qU_cov_W": 0.1 * rng.standard_normal((M, M)),
          "Y.qU_cov_diag": inv(np.full(M, 0.01))}}
params = carryover_params(state, [m], dtype="float32", device="cpu")
pred = BatchedPredictor(model=m, infr_params=params, observed=[m.X],
                        target_variables=[m.Y.uuid], chunk_size=32)
mu, var = pred.predict(X=rng.uniform(0, 4, (50, D)))[0]
assert mu.shape == var.shape == (1, 50, 1), (mu.shape, var.shape)
assert np.isfinite(mu).all() and np.isfinite(var).all()
assert var.min() >= -1e-6
jaxy = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                       "mxfusion_tpu")
        and sys.modules[k] is not None]
assert not jaxy, jaxy
print("SERVED", float(mu.mean()))
"""


def test_port_imports_and_serves_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_WITHOUT_JAX.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "SERVED" in proc.stdout


def _run_smoke(cwd, env=None):
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, timeout=300,
                          cwd=cwd, env=env)
    return proc.returncode, proc.stdout


def test_chip_smoke_fails_without_gpu():
    # no visible GPU, whether or not the machine has one
    rc, out = _run_smoke(ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert rc != 0
    assert '"ok": true' not in out


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    rc, out = _run_smoke(tmp_path)
    assert rc != 0
    assert '"ok": true' not in out
