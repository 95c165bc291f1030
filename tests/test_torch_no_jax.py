"""mxfusion_tpu_torch stands without JAX: a fresh interpreter in which
``import jax`` fails imports the port, trains the small slice with both
minibatch loops and serves it from a numpy state, runs the MVN slice
(structured-PPCA SVI, then forward sampling), fits and serves the
exact and collapsed GP modules, trains mean-field posteriors by SVI and
by the score-function estimator, fits and serves an SVGP classifier
and a Poisson SVGP, and fits and serves an LMC multi-output SVGP and
2-layer deep GPs (regression and classification) and trains an SVGP by
natural gradients, full batch and minibatch, and trains networks in the
graph (``NNFunction``: a Bayesian NN, a VAE and a deep-kernel SVGP,
served), and samples a conjugate posterior by HMC and SVGD, and fits a
masked MAP, approximates it by Laplace, scores HMC draws by WAIC,
PSIS-LOO and a predictive check, and integrates a power posterior, and
fits a linear-Gaussian state-space model and an AR(1) coefficient and
rolls PILCO out over GP dynamics, and runs the native batcher, the
loops' options, profiling and a data-parallel run. Also: chip_smoke.py refuses to run
without a GPU and without the rest of the repository."""
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


TRAIN_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.inference import (GradBasedInference, MAP,
                                          DeviceMinibatchLoop,
                                          MinibatchInferenceLoop)
from mxfusion_tpu_torch.ops import fused_gram, linalg, precision

N, M, D, B = 200, 8, 2, 64
rng = np.random.default_rng(0)
X = rng.uniform(0, 4, (N, D))
Y = np.sin(2 * X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
for Loop in (DeviceMinibatchLoop, MinibatchInferenceLoop):
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D), noise_var=m.noise_var,
        shape=(m.n, 1), inducing_inputs=Variable(
            shape=(M, D), initial_value=rng.uniform(0, 4, (M, D))))
    infr = GradBasedInference(
        MAP(model=m, observed=[m.X, m.Y]),
        grad_loop=Loop(batch_size=B, rv_scaling={{m.Y: N / B}}),
        device="cpu")
    losses = []
    infr.run(X=X, Y=Y, max_iter=5, learning_rate=0.05,
             callback=lambda e, l: losses.append(l))
    assert len(losses) == 5 and np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
jaxy = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                       "mxfusion_tpu")
        and sys.modules[k] is not None]
assert not jaxy, jaxy
print("TRAINED", losses[-1])
"""


PPCA_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
import torch
from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.models import Posterior
from mxfusion_tpu_torch.components.distributions import (
    MultivariateNormal, MultivariateNormalMeanPrecision, Normal)
from mxfusion_tpu_torch.components.functions import Function
from mxfusion_tpu_torch.components.functions.operators import (
    broadcast_to, dot)
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    ForwardSampling, GradBasedInference, StochasticVariationalInference,
    VariationalPosteriorForwardSampling)

N, Q, D = 24, 3, 5
rng = np.random.default_rng(0)
x = rng.standard_normal((N, Q)) @ rng.standard_normal((Q, D))
m = Model()
m.W = Variable(shape=(Q, D), initial_value=0.1 * rng.standard_normal((Q, D)))
m.z = MultivariateNormalMeanPrecision.define_variable(
    mean=broadcast_to(Variable(value=0.), (N, Q)),
    precision=broadcast_to(Variable(value=np.eye(Q)), (N, Q, Q)),
    shape=(N, Q))
m.noise = Variable(transformation=PositiveTransformation(), initial_value=1.)
m.x = Normal.define_variable(mean=dot(m.z, m.W),
                             variance=broadcast_to(m.noise, (N, D)),
                             shape=(N, D))
q = Posterior(m)
q.q_mu = Variable(shape=(N, Q))
q.q_A = Variable(shape=(N, Q, Q),
                 initial_value=np.tile(0.5 * np.eye(Q), (N, 1, 1)))
cov = Function(lambda A: A @ A.transpose(-1, -2) + 1e-3 * torch.eye(Q),
               input_names=["A"], output_names=["cov"],
               broadcastable=True)(q.q_A)
q.z.set_prior(MultivariateNormal(mean=q.q_mu, covariance=cov))
infr = GradBasedInference(StochasticVariationalInference(
    num_samples=4, model=m, posterior=q, observed=[m.x]), device="cpu")
losses = []
infr.run(x=x, max_iter=10, learning_rate=0.05,
         callback=lambda i, l: losses.append(float(l)))
assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
z, xs = VariationalPosteriorForwardSampling(
    num_samples=7, observed=[], inherited_inference=infr,
    target_variables=[m.z, m.x]).run()
assert z.shape == (7, N, Q) and xs.shape == (7, N, D)
(zp,) = ForwardSampling(num_samples=3, model=m, observed=[],
                        infr_params=infr.params,
                        target_variables=[m.z]).run()
assert zp.shape == (3, N, Q) and bool(torch.isfinite(zp).all())
jaxy = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                       "mxfusion_tpu")
        and sys.modules[k] is not None]
assert not jaxy, jaxy
print("PPCA", losses[-1])
"""


GP_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import set_default_device
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import (
    AddKernel, Bias, CombinationKernel, Kernel, Linear, Matern, Matern12,
    Matern32, Matern52, MultiplyKernel, NativeKernel, Periodic, Polynomial,
    RBF, RationalQuadratic, StationaryKernel, White)
from mxfusion_tpu_torch.modules import GPRegression, SparseGPRegression
from mxfusion_tpu_torch.inference import (BatchedPredictor,
                                          GradBasedInference, MAP)

set_default_device("cpu")
N, D = 60, 2
rng = np.random.default_rng(0)
X = rng.uniform(0, 4, (N, D))
Y = np.sin(2 * X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
for Module, kw in ((GPRegression, {{}}),
                   (SparseGPRegression, {{"inducing_inputs": Variable(
                       shape=(8, D), initial_value=rng.uniform(0, 4, (8, D)))
                   }})):
    m = Model()
    m.N = Variable()
    m.X = Variable(shape=(m.N, D))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    m.Y = Module.define_variable(
        X=m.X, kernel=RBF(D, active_dims=[0, 1]) + Matern52(D) + White(D),
        noise_var=m.noise_var, shape=(m.N, 1), **kw)
    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]))
    losses = []
    infr.run(X=X, Y=Y, max_iter=10, learning_rate=0.05,
             callback=lambda i, l: losses.append(float(l)))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    pred = BatchedPredictor(model=m, infr_params=infr.params,
                            observed=[m.X], target_variables=[m.Y.uuid],
                            chunk_size=16)
    Xt = rng.uniform(0, 4, (40, D))
    mu, var = pred.predict(X=Xt)[0]
    assert mu.shape == (1, 40, 1) and var.shape == (1, 40), (mu.shape,
                                                              var.shape)
    err = float(np.abs(mu[0] - np.sin(2 * Xt[:, :1])).mean())
    assert np.isfinite(var).all() and err < 0.5, err
jaxy = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                       "mxfusion_tpu")
        and sys.modules[k] is not None]
assert not jaxy, jaxy
print("GP", losses[-1])
"""


MEANFIELD_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
import torch
from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import set_default_device
from mxfusion_tpu_torch.components.distributions import (
    Exponential, Gamma, LogNormal, Normal)
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    GradBasedInference, ScoreFunctionInference,
    StochasticVariationalInference, create_Gaussian_meanfield)

set_default_device("cpu")
N = 100
rng = np.random.default_rng(0)
y = rng.standard_normal((N, 1)) * 2.0 + 3.0
for Alg in (StochasticVariationalInference, ScoreFunctionInference):
    m = Model()
    m.mu = Normal.define_variable(mean=0., variance=100., shape=(1,))
    m.s = Variable(transformation=PositiveTransformation(), initial_value=5.)
    m.y = Normal.define_variable(mean=broadcast_to(m.mu, (N, 1)),
                                 variance=broadcast_to(m.s, (N, 1)),
                                 shape=(N, 1))
    q = create_Gaussian_meanfield(model=m, observed=[m.y])
    infr = GradBasedInference(Alg(num_samples=10, model=m, posterior=q,
                                  observed=[m.y]))
    losses = []
    infr.run(y=y, max_iter=300, learning_rate=0.1,
             generator=torch.Generator().manual_seed(0),
             callback=lambda i, l: losses.append(float(l)))
    mu = float(infr.params[q.mu.factor.mean])
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert abs(mu - y.mean()) < 0.3, (Alg.__name__, mu, y.mean())
t = rng.exponential(1.0 / 1.7, (60, 1))
m = Model()
m.tau = Gamma.define_variable(alpha=2.0, beta=2.0, shape=(1,))
m.t = Exponential.define_variable(rate=broadcast_to(m.tau, (60, 1)),
                                  shape=(60, 1))
q = create_Gaussian_meanfield(model=m, observed=[m.t])
assert isinstance(q.tau.factor, LogNormal)
infr = GradBasedInference(StochasticVariationalInference(
    num_samples=10, model=m, posterior=q, observed=[m.t]))
infr.run(t=t, max_iter=200, learning_rate=0.05)
assert np.isfinite(float(infr.params[q.tau.factor.mean]))
jaxy = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                       "mxfusion_tpu")
        and sys.modules[k] is not None]
assert not jaxy, jaxy
print("MEANFIELD", mu)
"""


NONGAUSSIAN_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
import torch
from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import set_default_device
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.inference import (BatchedPredictor,
                                          DeviceMinibatchLoop,
                                          GradBasedInference, MAP)
from mxfusion_tpu_torch.modules import (SVGPClassification,
                                        SVGPPoissonRegression)

set_default_device("cpu")
N, M, D, B = 256, 12, 2, 64
rng = np.random.default_rng(0)
X = rng.uniform(0, 4, (N, D))
f = 2.0 * np.sin(2.0 * X[:, :1])
labels = (rng.random((N, 1)) < 1.0 / (1.0 + np.exp(-3.0 * f))) * 1.0
counts = rng.poisson(np.exp(f)).astype(np.float64)
Xt = rng.uniform(0, 4, (100, D))
for Module, Y, kw in ((SVGPClassification, labels, dict(link="probit")),
                      (SVGPPoissonRegression, counts,
                       dict(link="softplus"))):
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    m.Y = Module.define_variable(
        X=m.X, kernel=RBF(input_dim=D), shape=(m.n, 1),
        inducing_inputs=Variable(shape=(M, D),
                                 initial_value=rng.uniform(0, 4, (M, D))),
        **kw)
    infr = GradBasedInference(
        MAP(model=m, observed=[m.X, m.Y]),
        grad_loop=DeviceMinibatchLoop(batch_size=B,
                                      rv_scaling={{m.Y: N / B}}))
    losses = []
    infr.run(X=X, Y=Y, max_iter=8, learning_rate=0.05,
             generator=torch.Generator().manual_seed(0),
             callback=lambda e, l: losses.append(l))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    pred = BatchedPredictor(model=m, infr_params=infr.params,
                            observed=[m.X], target_variables=[m.Y.uuid],
                            chunk_size=64)
    mean, var = pred.predict(X=Xt)[0]
    assert mean.shape == var.shape == (1, 100, 1)
    assert np.isfinite(mean).all() and (var >= 0).all()
    if Module is SVGPClassification:
        assert 0.0 < mean.min() and mean.max() < 1.0
jaxy = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                       "mxfusion_tpu")
        and sys.modules[k] is not None]
assert not jaxy, jaxy
print("NONGAUSSIAN", losses[-1])
"""


GP_FAMILY_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
import torch
from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import set_default_device
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    BatchedPredictor, DeviceMinibatchLoop, GradBasedInference, MAP,
    NaturalGradientLoop, NaturalGradientMinibatchLoop)
from mxfusion_tpu_torch.modules import (DeepGPClassification,
                                        DeepGPRegression, LMCSVGPRegression,
                                        SVGPRegression)

set_default_device("cpu")
N, M, D, B = 256, 10, 2, 64
rng = np.random.default_rng(1)
X = rng.uniform(0, 4, (N, D))
f = np.sin(2.0 * X[:, :1])
Xt = rng.uniform(0, 4, (70, D))


def fit(m, Y, loop=None, steps=8, lr=0.05):
    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                              grad_loop=loop)
    losses = []
    infr.run(X=X, Y=Y, max_iter=steps, learning_rate=lr,
             generator=torch.Generator().manual_seed(0),
             callback=lambda e, l: losses.append(float(l)))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    pred = BatchedPredictor(model=m, infr_params=infr.params,
                            observed=[m.X], target_variables=[m.Y.uuid],
                            chunk_size=32)
    return losses, pred.predict(X=Xt)[0]


def model():
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    return m


Z = lambda d: Variable(shape=(M, d), initial_value=rng.uniform(0, 4, (M, d)))
# LMC: three outputs mixed from two latent functions
m = model()
Y3 = np.concatenate([f, np.cos(X[:, 1:]), f - np.cos(X[:, 1:])], 1)
m.Y = LMCSVGPRegression.define_variable(
    X=m.X, kernel=RBF(input_dim=D), num_outputs=3, num_latents=2,
    shape=(m.n, 3), inducing_inputs=Z(D))
_, (mu, var) = fit(m, Y3 + 0.05 * rng.standard_normal((N, 3)), steps=30)
assert mu.shape == var.shape == (1, 70, 3) and (var >= 0).all()
# 2-layer deep GPs through the device loop
for Module, Y, kw in ((DeepGPRegression, f + 0.1 * rng.standard_normal(
                           (N, 1)), dict(noise_var=Variable(
                           transformation=PositiveTransformation(),
                           initial_value=0.1))),
                      (DeepGPClassification, (f > 0) * 1.0, {{}})):
    m = model()
    m.Y = Module.define_variable(
        X=m.X, kernels=[RBF(input_dim=D), RBF(input_dim=D)],
        shape=(m.n, 1), inducing_inputs=[Z(D), Z(D)], **kw)
    _, (mean, var) = fit(m, Y, DeviceMinibatchLoop(
        batch_size=B, rv_scaling={{m.Y: N / B}}))
    assert mean.shape == var.shape == (1, 70, 1)
    assert np.isfinite(mean).all() and (var >= 0).all()
# natural gradients on SVGP regression, full batch and minibatch
for make in (lambda m: NaturalGradientLoop(m.Y.factor, 0.5),
             lambda m: NaturalGradientMinibatchLoop(
                 m.Y.factor, batch_size=B, rv_scaling={{m.Y: N / B}},
                 nat_learning_rate=0.2)):
    m = model()
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D), noise_var=m.noise_var,
        shape=(m.n, 1), inducing_inputs=Z(D), jitter=1e-6)
    loop = make(m)
    losses, (mu, _) = fit(m, f + 0.1 * rng.standard_normal((N, 1)), loop)
    assert loop.guard_trips == 0 and np.isfinite(mu).all()
jaxy = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                       "mxfusion_tpu")
        and sys.modules[k] is not None]
assert not jaxy, jaxy
print("GPFAMILY", losses[-1])
"""


NN_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
import torch
from mxfusion_tpu_torch import Model, Posterior, Variable
from mxfusion_tpu_torch.common.config import set_default_device
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.components.functions import NNFunction
from mxfusion_tpu_torch.components.functions.operators import (
    broadcast_to, mean, sum, transpose)
from mxfusion_tpu_torch.components.variables import (
    PositiveTransformation, add_sample_dimension, get_num_samples)
from mxfusion_tpu_torch.inference import (
    MAP, BatchedPredictor, GradBasedInference,
    StochasticVariationalInference, VariationalPosteriorForwardSampling,
    create_Gaussian_meanfield)
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.util.carryover import linear_stack_map

set_default_device("cpu")
torch.manual_seed(0)
rng = np.random.default_rng(0)
N = 64
x = rng.random((N, 2)) * 2 - 1
y = np.sin(3 * x[:, :1]) + 0.05 * rng.standard_normal((N, 1))

def mlp(*w):
    layers = []
    for a, b in zip(w[:-1], w[1:]):
        layers += [torch.nn.Linear(a, b), torch.nn.Tanh()]
    return torch.nn.Sequential(*layers[:-1])

# a Bayesian NN under mean-field SVI, then forward sampling
net = NNFunction(mlp(2, 8, 1), name="f", input_shapes=[(N, 2)])
m = Model()
m.x = Variable(shape=(N, 2))
m.r = net(m.x)
for v in net.parameters.values():
    v.set_prior(Normal(mean=broadcast_to(Variable(value=0.), v.shape),
                       variance=broadcast_to(Variable(value=1.), v.shape)))
m.noise = Variable(transformation=PositiveTransformation(), initial_value=0.1)
m.y = Normal.define_variable(mean=m.r, variance=broadcast_to(m.noise, (N, 1)),
                             shape=(N, 1))
q = create_Gaussian_meanfield(model=m, observed=[m.x, m.y])
bnn = GradBasedInference(StochasticVariationalInference(
    num_samples=3, model=m, posterior=q, observed=[m.x, m.y]))
losses = []
bnn.run(x=x, y=y, max_iter=60, learning_rate=0.05,
        callback=lambda i, l: losses.append(float(l)))
assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
(draws,) = VariationalPosteriorForwardSampling(
    num_samples=10, observed=[m.x], inherited_inference=bnn,
    target_variables=[m.y]).run(x=x)
assert tuple(draws.shape) == (10, N, 1)

# a VAE: decoder in the model, two-headed encoder in the posterior
class Encoder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.h, self.mu, self.lv = (torch.nn.Linear(3, 8),
                                    torch.nn.Linear(8, 2),
                                    torch.nn.Linear(8, 2))
    def forward(self, v):
        h = torch.tanh(self.h(v))
        return self.mu(h), torch.exp(self.lv(h)) + 1e-6

xv = np.tanh(rng.standard_normal((N, 2)) @ rng.standard_normal((2, 3)))
m = Model()
m.z = Normal.define_variable(mean=broadcast_to(Variable(value=0.), (N, 2)),
                             variance=broadcast_to(Variable(value=1.),
                                                   (N, 2)), shape=(N, 2))
m.x_mean = NNFunction(mlp(2, 8, 3), name="dec", input_shapes=[(N, 2)])(m.z)
m.x = Normal.define_variable(
    mean=m.x_mean, variance=broadcast_to(Variable(value=0.01), (N, 3)),
    shape=(N, 3))
q = Posterior(m)
q_mean, q_var = NNFunction(Encoder(), name="enc", input_shapes=[(N, 3)],
                           num_outputs=2)(q.x)
q.z.set_prior(Normal(mean=q_mean, variance=q_var))
vae = GradBasedInference(StochasticVariationalInference(
    num_samples=2, model=m, posterior=q, observed=[m.x]))
vae_losses = []
vae.run(x=xv, max_iter=30, learning_rate=0.01,
        callback=lambda i, l: vae_losses.append(float(l)))
assert vae_losses[-1] < vae_losses[0], vae_losses

# a deep-kernel SVGP, trained by MAP and served from the raw inputs
feat = mlp(2, 8, 2)
m = Model()
m.n = Variable()
m.X_raw = Variable(shape=(m.n, 2))
m.features = NNFunction(feat, name="feat", input_shapes=[(N, 2)])(m.X_raw)
m.noise_var = Variable(transformation=PositiveTransformation(),
                       initial_value=0.05)
m.Y = SVGPRegression.define_variable(
    X=m.features, kernel=RBF(input_dim=2), noise_var=m.noise_var,
    shape=(m.n, 1), inducing_inputs=Variable(
        shape=(8, 2), initial_value=rng.standard_normal((8, 2)) * 0.5))
dk = GradBasedInference(MAP(model=m, observed=[m.X_raw, m.Y]))
dk_losses = []
dk.run(X_raw=x, Y=y, max_iter=50, learning_rate=0.02,
       callback=lambda i, l: dk_losses.append(float(l)))
assert dk_losses[-1] < dk_losses[0], dk_losses
mu, var = BatchedPredictor(model=m, infr_params=dk.params,
                           observed=[m.X_raw], target_variables=[m.Y.uuid],
                           chunk_size=16).predict(X_raw=x[:40])[0]
assert mu.shape == var.shape == (1, 40, 1) and np.isfinite(mu).all()
assert sorted(linear_stack_map("feat", feat)) == [
    "feat_Dense_0_bias", "feat_Dense_0_kernel", "feat_Dense_1_bias",
    "feat_Dense_1_kernel"]

# the operators and the sugar
m = Model()
m.a = Variable(shape=(2, 3))
m.b = sum(transpose(2.0 * m.a - 1.0), axis=0) + mean(-m.a, axis=1)
a = add_sample_dimension(torch.ones(2, 3, dtype=torch.float64))
assert get_num_samples(a) == 1
env = {{m.a.uuid: a}}
for v in m.get_constants():
    env[v.uuid] = torch.tensor([float(v.constant)], dtype=torch.float64)
out = m.draw_samples(env, torch.Generator())[m.b.uuid]
assert torch.allclose(out, torch.full((1, 2), 2.0, dtype=torch.float64))
jaxy = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                       "mxfusion_tpu", "flax")
        and sys.modules[k] is not None]
assert not jaxy, jaxy
print("NN", losses[-1], vae_losses[-1], dk_losses[-1])
"""


SAMPLERS_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.set_num_threads(1)           # small ops: threads only contend
from mxfusion_tpu_torch.common.config import set_default_device
set_default_device("cpu")
from mxfusion_tpu_torch import Model
from mxfusion_tpu_torch.components.distributions import Gamma, Exponential
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.inference import (HMCAlgorithm, HMCInference,
                                          SVGDAlgorithm, SVGDInference)

# tau ~ Gamma(2, 2); y_i ~ Exp(tau): the posterior is Gamma(2+N, 2+sum y)
N = 60
y = np.random.default_rng(1).exponential(1.0 / 1.7, (N, 1))
m = Model()
m.tau = Gamma.define_variable(alpha=2.0, beta=2.0, shape=(1,))
m.y = Exponential.define_variable(rate=broadcast_to(m.tau, (N, 1)),
                                  shape=(N, 1))
a, b = 2 + N, 2 + y.sum()
infr = HMCInference(HMCAlgorithm(model=m, observed=[m.y], num_samples=200,
                                 num_warmup=100, num_chains=4,
                                 num_leapfrog=8))
tau = infr.run(y=y, generator=torch.Generator().manual_seed(0))[m.tau.uuid]
assert tuple(tau.shape) == (200, 4, 1) and bool((tau > 0).all())
assert abs(float(tau.mean()) - a / b) < 0.1 * a / b, (float(tau.mean()), a / b)
particles = SVGDInference(SVGDAlgorithm(
    model=m, observed=[m.y], num_particles=16, num_iterations=20,
    step_size=0.1)).run(y=y, generator=torch.Generator().manual_seed(1))
assert tuple(particles[m.tau.uuid].shape) == (16, 1)
assert bool(torch.isfinite(particles[m.tau.uuid]).all())
jaxy = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                       "mxfusion_tpu")
        and sys.modules[k] is not None]
assert not jaxy, jaxy
print("SAMPLERS", float(tau.mean()), a / b)
"""


EVIDENCE_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.set_num_threads(1)           # small ops: threads only contend
from mxfusion_tpu_torch.common.config import set_default_device
set_default_device("cpu")
from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions import (Gamma, Exponential,
                                                         Normal)
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.inference import (
    GradBasedInference, HMCAlgorithm, HMCInference, MAP,
    PowerPosteriorAlgorithm, PowerPosteriorInference, laplace_approximation,
    loo_psis, pointwise_log_likelihood, posterior_predictive_check, waic)

N = 40
rng = np.random.default_rng(0)
y = rng.standard_normal((N, 1)) + 2.0
mask = (rng.random((N, 1)) < 0.8).astype(np.float64)

def normal_mean():
    m = Model()
    m.mu = Normal.define_variable(mean=0., variance=100., shape=(1,))
    m.y = Normal.define_variable(
        mean=broadcast_to(m.mu, (N, 1)),
        variance=broadcast_to(Variable(value=1.0), (N, 1)), shape=(N, 1))
    return m

# masked MAP, then Laplace: the conjugate posterior of the kept points
m = normal_mean()
infr = GradBasedInference(MAP(model=m, observed=[m.y]), dtype="float64")
infr.run(y=np.where(mask > 0, y, 1e6), max_iter=300, learning_rate=0.1,
         rv_scaling={{m.y: mask}})
lap = laplace_approximation(infr, y=y)
mean, cov = lap.marginal(m.mu)
k = mask.sum()
post_var = 1.0 / (k + 0.01)
assert abs(float(mean[0]) - (y * mask).sum() * post_var) < 1e-3
# all N points: Laplace drops the run's mask, as the JAX package does
assert abs(float(cov[0, 0]) - 1.0 / (N + 0.01)) < 1e-12
# HMC draws, then WAIC, PSIS-LOO and a predictive check
m = normal_mean()
hinf = HMCInference(HMCAlgorithm(model=m, observed=[m.y], num_samples=100,
                                 num_warmup=50, num_chains=2,
                                 num_leapfrog=4))
hinf.run(y=y, generator=torch.Generator().manual_seed(0))
ll = pointwise_log_likelihood(hinf, y=y)["y"]
assert tuple(ll.shape) == (200, N)
w, lo = waic(ll), loo_psis(ll)
assert abs(w["elpd_waic"] - lo["elpd_loo"]) < 2.0 and 0.2 < w["p_waic"] < 3.0
ppc = posterior_predictive_check(hinf, lambda r: r.var(correction=0), "y",
                                 y=y)
assert 0.0 <= ppc["p_value"] <= 1.0
# thermodynamic integration on a short ladder
y2 = rng.exponential(1.0 / 1.7, (N, 1))
m = Model()
m.tau = Gamma.define_variable(alpha=2.0, beta=2.0, shape=(1,))
m.y = Exponential.define_variable(rate=broadcast_to(m.tau, (N, 1)),
                                  shape=(N, 1))
ti = PowerPosteriorInference(PowerPosteriorAlgorithm(
    model=m, observed=[m.y], num_samples=20, num_warmup=20, num_chains=2,
    num_temps=4, num_leapfrog=4))
ti.run(y=y2, generator=torch.Generator().manual_seed(1))
assert np.isfinite(ti.log_evidence)
assert ti.diagnostics["potential_evaluations"] == 1 + 5 * 40
jaxy = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                       "mxfusion_tpu")
        and sys.modules[k] is not None]
assert not jaxy, jaxy
print("EVIDENCE", lap.log_evidence, w["elpd_waic"], ti.log_evidence)
"""


STATE_SPACE_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.set_num_threads(1)           # small ops: threads only contend
from mxfusion_tpu_torch.common.config import set_default_device
set_default_device("cpu")
from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions import (GaussianAR1,
                                                         LinearGaussianSSM)
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import GPRegression
from mxfusion_tpu_torch.inference import (GradBasedInference,
                                          GradTransferInference, MAP,
                                          PILCOAlgorithm)
from mxfusion_tpu_torch.ops.kalman import (
    kalman_filter, kalman_filter_parallel, lgssm_sample, rts_smoother,
    rts_smoother_parallel)

# an SSM fitted by MAP through the sequential filter
A = torch.tensor([[0.9, 0.2], [0.0, 0.7]], dtype=torch.float64)
H = torch.tensor([[1.0, 0.5]], dtype=torch.float64)
Q, R = torch.eye(2, dtype=torch.float64) * 0.05, \
    torch.eye(1, dtype=torch.float64) * 0.1
m0, P0 = torch.zeros(2, dtype=torch.float64), torch.eye(2, dtype=torch.float64)
_, y = lgssm_sample(torch.Generator().manual_seed(0), 60, A, H, Q, R, m0, P0)
m = Model()
m.A = Variable(shape=(2, 2), initial_value=np.eye(2) * 0.5)
m.y = LinearGaussianSSM.define_variable(
    A=m.A, H=Variable(value=H.numpy()), trans_cov=Variable(value=Q.numpy()),
    obs_cov=Variable(value=R.numpy()), initial_mean=Variable(value=np.zeros(2)),
    initial_cov=Variable(value=np.eye(2)), shape=(60, 1), dtype="float64")
losses = []
infr = GradBasedInference(MAP(model=m, observed=[m.y]), dtype="float64")
infr.run(y=y.numpy(), max_iter=10, learning_rate=0.05,
         callback=lambda i, l: losses.append(float(l)))
assert losses[-1] < losses[0], losses
# the parallel filter and smoother agree with the sequential ones
seq, par = (f(y, A, H, Q, R, m0, P0) for f in (kalman_filter,
                                               kalman_filter_parallel))
assert abs(float(seq["loglik"] - par["loglik"])) < 1e-9
s1, s2 = (f(seq["filtered_means"], seq["filtered_covs"], seq["pred_means"],
            seq["pred_covs"], A) for f in (rts_smoother, rts_smoother_parallel))
assert torch.allclose(s1[0], s2[0], atol=1e-10)
# an AR(1) coefficient fitted by MAP
m2 = Model()
m2.phi = Variable(shape=(1,), initial_value=0.5)
m2.x = GaussianAR1.define_variable(phi=m2.phi, noise_var=Variable(value=0.1),
                                   shape=(30,))
ar = GradBasedInference(MAP(model=m2, observed=[m2.x]), dtype="float64")
ar.run(x=0.9 ** np.arange(30.0), max_iter=20, learning_rate=0.05)
assert float(ar.params[m2.phi][0]) > 0.5
# one PILCO rollout over GP dynamics
rng = np.random.default_rng(0)
S, U = rng.standard_normal((30, 1)), rng.uniform(-1, 1, (30, 1))
X, Y = np.concatenate([S, U], -1), 0.8 * S + 0.5 * U
g = Model()
g.N = Variable()
g.X = Variable(shape=(g.N, 2))
g.noise_var = Variable(transformation=PositiveTransformation(),
                       initial_value=0.01)
g.Y = GPRegression.define_variable(X=g.X, kernel=RBF(input_dim=2),
                                   noise_var=g.noise_var, shape=(g.N, 1))
dyn = GradBasedInference(MAP(model=g, observed=[g.X, g.Y]))
dyn.run(max_iter=10, learning_rate=0.05, X=X, Y=Y)
g.w = Variable(shape=(1, 1), initial_value=np.zeros((1, 1)))
alg = PILCOAlgorithm(
    model=g, observed=[], n_time_steps=5, num_samples=3,
    cost_function=lambda s, a: torch.sum(torch.square(s)),
    policy=lambda s, env: torch.einsum("...i,ij->...j", s, env[g.w][0]),
    initial_state_generator=lambda k: torch.ones((k, 1)))
cost = GradTransferInference(inference_algorithm=alg,
                             infr_params=dyn.params).run(max_iter=1)
assert np.isfinite(cost)
jaxy = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                       "mxfusion_tpu")
        and sys.modules[k] is not None]
assert not jaxy, jaxy
print("STATESPACE", losses[0], losses[-1], float(cost))
"""


LOOPS_WITHOUT_JAX = r"""
import sys, tempfile
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
import torch
from mxfusion_tpu_torch.common.config import set_default_device
set_default_device("cpu")
from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.inference import (GradBasedInference, MAP,
                                          MinibatchInferenceLoop)
from mxfusion_tpu_torch.native import native_available, shuffled_indices
from mxfusion_tpu_torch.parallel import (DataParallelMinibatchLoop,
                                         make_mesh, shard_data)
from mxfusion_tpu_torch.util.profiling import StepTimer, annotate, trace

assert sorted(shuffled_indices(50, 3)) == list(range(50))
rng = np.random.default_rng(0)
X = rng.uniform(0, 4, (200, 1))
Y = np.sin(X) + 0.1 * rng.standard_normal((200, 1))


def fit(loop_of, **kw):
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, 1))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=1), noise_var=m.noise_var,
        shape=(m.n, 1), inducing_inputs=Variable(
            shape=(8, 1), initial_value=np.linspace(0, 4, 8)[:, None]))
    losses = []
    GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                       grad_loop=loop_of(m)).run(
        max_iter=4, learning_rate=0.05, X=X, Y=Y,
        callback=lambda e, l: losses.append(l), **kw)
    return losses


timer = StepTimer()
with tempfile.TemporaryDirectory() as d, trace(d), annotate("fit"):
    plain = fit(lambda m: MinibatchInferenceLoop(
        batch_size=40, rv_scaling={{m.Y: 5.0}}, batches_per_call=5),
        remat=True)
assert plain[-1] < plain[0], plain
mesh = make_mesh()                  # a world of one, over a local store
dp = fit(lambda m: DataParallelMinibatchLoop(
    mesh, batch_size=40, rv_scaling={{m.Y: 5.0}}, batches_per_call=5))
np.testing.assert_allclose(dp, plain, rtol=1e-6)
assert shard_data(mesh, [X])[0].shape == X.shape
assert timer.rate(1) > 0
jaxy = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                       "mxfusion_tpu")
        and sys.modules[k] is not None]
assert not jaxy, jaxy
print("LOOPS", native_available(), plain[0], plain[-1])
"""


def test_port_runs_loop_options_and_data_parallel_without_jax():
    """The native batcher, ``batches_per_call``, ``remat``, profiling and
    a data-parallel minibatch run over a world of one, in an interpreter
    without JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", LOOPS_WITHOUT_JAX.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "LOOPS" in proc.stdout


def test_port_fits_state_space_models_and_pilco_without_jax():
    """A LinearGaussianSSM fitted by MAP, the parallel filter and smoother
    against the sequential ones, and a PILCO rollout over GP dynamics, in
    an interpreter without JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", STATE_SPACE_WITHOUT_JAX.format(
            root=str(ROOT))],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "STATESPACE" in proc.stdout


def test_port_computes_evidence_and_criticism_without_jax():
    """A masked MAP fit and its Laplace approximation, WAIC, PSIS-LOO and
    a predictive check on HMC draws, and thermodynamic integration run in
    an interpreter without JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", EVIDENCE_WITHOUT_JAX.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "EVIDENCE" in proc.stdout


def test_port_samples_by_hmc_and_svgd_without_jax():
    """A Gamma-Exponential HMC chain lands on the conjugate posterior's
    mean, and SVGD runs a few iterations, in an interpreter without
    JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", SAMPLERS_WITHOUT_JAX.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "SAMPLERS" in proc.stdout


def test_port_fits_nn_models_without_jax():
    """A Bayesian NN (SVI, forward sampling), a VAE and a deep-kernel
    SVGP (MAP, ``BatchedPredictor`` on the raw inputs) train through
    ``NNFunction``, and the reductions, ``transpose`` and the operator
    sugar evaluate, in an interpreter without JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", NN_WITHOUT_JAX.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "NN" in proc.stdout


def test_port_fits_lmc_deep_gps_and_natural_gradients_without_jax():
    """An LMC SVGP and 2-layer deep GPs (regression and classification)
    train by MAP and serve, and SVGP regression trains by natural
    gradients (full batch and minibatch), in an interpreter without
    JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", GP_FAMILY_WITHOUT_JAX.format(
            root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "GPFAMILY" in proc.stdout


def test_port_fits_and_serves_nongaussian_svgps_without_jax():
    """An SVGP classifier (probit) and a Poisson SVGP (softplus link)
    train by MAP through the device loop and serve through
    BatchedPredictor in an interpreter without JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", NONGAUSSIAN_WITHOUT_JAX.format(
            root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "NONGAUSSIAN" in proc.stdout


def test_port_trains_meanfield_svi_and_bbvi_without_jax():
    """Mean-field SVI and BBVI recover a latent mean, and SVI runs over a
    Gamma latent through its LogNormal factor, without JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", MEANFIELD_WITHOUT_JAX.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "MEANFIELD" in proc.stdout


def test_port_fits_and_predicts_gp_modules_without_jax():
    """The exact and collapsed GP modules, on a sum kernel, train by MAP
    and serve through BatchedPredictor in an interpreter without JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", GP_WITHOUT_JAX.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "GP" in proc.stdout


def test_port_runs_the_mvn_slice_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", PPCA_WITHOUT_JAX.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "PPCA" in proc.stdout


def test_port_trains_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", TRAIN_WITHOUT_JAX.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "TRAINED" in proc.stdout


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
