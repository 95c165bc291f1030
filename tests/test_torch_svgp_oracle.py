"""The port's SVGP training run against the independent oracle.

Counterpart of ``tests/modules/test_svgp_independent_oracle.py``: the
port's full-batch MAP trajectory (the bound, its gradients through
autograd and ``torch.optim.Adam``, step by step) must match
``tests/oracles/svgp_torch_oracle.py``, the textbook Hensman bound and a
hand-written optax-style Adam in float64 that imports neither package.
The oracle sets torch's default dtype to float64 when imported, so it
runs in a subprocess of its own. The JAX test runs the BASELINE ladder's
100k points and 100 inducing points and is marked slow; this one cuts
the size (N = 2000, M = 40; D, the steps, the learning rate and the
jitter are the JAX test's) and keeps its tolerances.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import MAP, GradBasedInference
from mxfusion_tpu_torch.modules import SVGPRegression

N, M, D = 2000, 40, 2
STEPS = 50
LR = 1e-2
JITTER = 1e-5
TESTS = os.path.dirname(os.path.abspath(__file__))

_ORACLE = r'''
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from oracles import svgp_torch_oracle as oracle
d = np.load(sys.argv[2])
init = {k[5:]: d[k] for k in d.files if k.startswith("init_")}
losses, final = oracle.run_trajectory(init, d["X"], d["Y"],
                                      jitter=float(d["jitter"]),
                                      lr=float(d["lr"]),
                                      n_steps=int(d["steps"]))
np.savez(sys.argv[3], losses=np.asarray(losses),
         **{"final_" + k: v for k, v in final.items()})
'''


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """On the CPU, one torch thread: the run is a loop of small products,
    which threads beside the other test workers only slow."""
    old = tconfig.set_default_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tconfig.set_default_device(old)


def test_svgp_trajectory_matches_torch_oracle(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.random((N, D)) * 4.0
    Y = (np.sin(X[:, :1]) + np.cos(X[:, 1:2] * 0.5)
         + rng.standard_normal((N, 1)) * 0.1)
    Z0 = rng.random((M, D)) * 4.0

    m = Model()
    m.N = Variable()
    m.X = Variable(shape=(m.N, D))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    kernel = RBF(input_dim=D, variance=1.2, lengthscale=0.7,
                 dtype="float64")
    zvar = Variable(shape=(M, D), initial_value=Z0)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=kernel, noise_var=m.noise_var, shape=(m.N, 1),
        inducing_inputs=zvar, dtype="float64", jitter=JITTER)
    infr = GradBasedInference(inference_algorithm=MAP(
        model=m, observed=[m.X, m.Y]), dtype="float64")
    infr.initialize(X=X, Y=Y)

    post = m.Y.factor._extra_graphs[0]
    uuid_to_role = {
        zvar.uuid: "Z",
        m.noise_var.uuid: "raw_noise",
        kernel.variance.uuid: "raw_variance",
        kernel.lengthscale.uuid: "raw_lengthscale",
        post.qU_mean.uuid: "qU_mean",
        post.qU_cov_W.uuid: "qU_cov_W",
        post.qU_cov_diag.uuid: "raw_qU_cov_diag",
    }
    raw = dict(infr.params.param_dict)
    assert set(uuid_to_role) == set(raw), (
        "trainable-parameter inventory changed; update the oracle map")
    init = {role: raw[u].numpy() for u, role in uuid_to_role.items()}

    # the oracle's trajectory from the same start, in its own process
    inputs, outputs = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inputs, X=X, Y=Y, jitter=JITTER, lr=LR, steps=STEPS,
             **{"init_" + k: v for k, v in init.items()})
    script = tmp_path / "oracle.py"
    script.write_text(_ORACLE)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(script), TESTS, str(inputs), str(outputs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)

    fw_losses = []
    infr.run(max_iter=STEPS, learning_rate=LR, optimizer="adam", X=X,
             Y=Y, callback=lambda i, l: fw_losses.append(float(l)))

    log = proc.communicate(timeout=120)[0].decode()
    assert proc.returncode == 0, log[-2000:]
    oracle = np.load(outputs)
    assert len(fw_losses) == len(oracle["losses"]) == STEPS
    np.testing.assert_allclose(fw_losses, oracle["losses"], rtol=1e-5)
    # the optimized states agree too (not just the loss curve)
    np.testing.assert_allclose(
        infr.params.param_dict[post.qU_mean.uuid].numpy(),
        oracle["final_qU_mean"], rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(
        infr.params.param_dict[kernel.lengthscale.uuid].numpy(),
        oracle["final_raw_lengthscale"], rtol=1e-4)
