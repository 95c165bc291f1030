"""Generate the tutorial notebooks of the PyTorch port.

The PyTorch counterparts of ``examples/notebooks/*.ipynb``: the same 9
topics, sections, data, sizes and printed lines, written against
``mxfusion_tpu_torch`` with ``torch.nn`` networks and ``torch.Generator``
draws. Regenerate from the repository's root with:

    python examples/torch/notebooks/generate.py             # cells only
    python examples/torch/notebooks/generate.py --execute   # + outputs
    python examples/torch/notebooks/generate.py --out DIR   # elsewhere

``--execute`` runs every code cell (one namespace per notebook) on the
CPU, on one torch thread, with fixed seeds, and embeds the captured
standard output as the cells' outputs. The cells themselves run on the
card unless the CPU was asked for, as the scripts of ``examples/torch/``
do. Only ``json`` is needed: neither nbformat nor jupyter.
"""
import contextlib
import copy
import hashlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

# the line every notebook's first markdown cell ends with
CPU_OUTPUTS = """
The outputs below were executed on the CPU (`generate.py --execute`:
one torch thread, fixed seeds). On the card the same cells launch the
port's CUDA kernels and print other draws of the random values."""


def _cell_id(text):
    """Deterministic cell id (hash of the source): regeneration is
    idempotent, so adding one notebook never churns the ids of the
    other committed notebooks."""
    return hashlib.sha256(text.encode()).hexdigest()[:8]


def md(text):
    return {"cell_type": "markdown", "metadata": {},
            "id": _cell_id(text),
            "source": text.splitlines(keepends=True)}


def code(text):
    return {"cell_type": "code", "metadata": {}, "execution_count": None,
            "id": _cell_id(text), "outputs": [],
            "source": text.strip("\n").splitlines(keepends=True)}


def _dedupe_ids(cells):
    """nbformat 4.5 requires cell ids unique within a notebook; two
    cells with the same source would hash to the same id. Repeats are
    salted with their occurrence index, still deterministically."""
    seen = {}
    for cell in cells:
        cid = cell["id"]
        n = seen.get(cid, 0)
        seen[cid] = n + 1
        if n:
            cell["id"] = _cell_id("{}#{}".format(cid, n))
    return cells


def write(out_dir, name, cells):
    nb = {
        "cells": _dedupe_ids(cells),
        "metadata": {
            "kernelspec": {"display_name": "Python 3",
                           "language": "python", "name": "python3"},
            "language_info": {"name": "python", "version": "3.12"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(nb, f, indent=1)
        f.write("\n")
    print("wrote", path)
    return path


# the helper the network notebooks define: flax's Dense start, drawn from
# an explicit generator
LECUN_NORMAL = '''

def lecun_normal_(module, generator):
    """Every nn.Linear of module to LeCun-normal weights (variance
    1/fan_in, truncated at two standard deviations, as flax's Dense
    starts) and zero biases, drawn from generator."""
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            std = layer.in_features ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            nn.init.zeros_(layer.bias)
    return module
'''

NOTEBOOKS = {}

# ---------------------------------------------------------------- 1
NOTEBOOKS["getting_started.ipynb"] = [
    md("""# Getting started with mxfusion_tpu_torch

`mxfusion_tpu_torch` is the PyTorch and CUDA port of `mxfusion_tpu`, a
probabilistic programming framework with the modeling surface of
MXFusion. This tutorial estimates the mean and variance of noisy
observations with a mean-field variational posterior trained by
reparameterized SVI — the counterpart of the reference's
`getting_started.ipynb`.

A model is a factor graph: attach variables to a `Model`, give random
variables distributions, and the graph is built for you. Everything
runs on the default device, the NVIDIA GPU unless
`mxfusion_tpu_torch.common.config.set_default_device("cpu")` was
called first; every random draw comes from a `torch.Generator` on that
device.
""" + CPU_OUTPUTS),
    code("""
import numpy as np
import torch

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import get_default_device
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.components.variables import PositiveTransformation

device = get_default_device()   # the card unless the CPU was asked for
N = 100
rng = np.random.default_rng(0)
y = rng.standard_normal((N, 1)) * 2.0 + 3.0
"""),
    md("""## Model definition

`m.mu` is the unknown mean with a wide Normal prior; `m.s` is the
observation variance, constrained positive through a softplus
bijector (the optimizer works in unconstrained space). Explicit
`broadcast_to` stretches the scalar latents over the `(N, 1)` data
shape — broadcasting across data dims is explicit, as in the
reference framework."""),
    code("""
m = Model()
m.mu = Normal.define_variable(mean=0., variance=100., shape=(1,))
m.s = Variable(transformation=PositiveTransformation(),
               initial_value=5.)
m.y = Normal.define_variable(mean=broadcast_to(m.mu, (N, 1)),
                             variance=broadcast_to(m.s, (N, 1)),
                             shape=(N, 1))
"""),
    md("""## Variational inference

`create_Gaussian_meanfield` builds the posterior factor graph —
an independent (transformed) Normal per latent, with the factor
family following each latent's support. Each step evaluates the SVI
objective over the graph on the device, differentiates it by autograd
and takes a `torch.optim.Adam` step; q's starting means and every
Monte-Carlo draw come from the generator passed to `run`. This model
has no GP gram and no Cholesky, so it launches none of the port's CUDA
kernels."""),
    code("""
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference,
    create_Gaussian_meanfield)

q = create_Gaussian_meanfield(model=m, observed=[m.y])
alg = StochasticVariationalInference(num_samples=10, model=m,
                                     posterior=q, observed=[m.y])
infr = GradBasedInference(inference_algorithm=alg)
infr.run(max_iter=500, learning_rate=0.1, y=y, verbose=True,
         generator=torch.Generator(device).manual_seed(0))
"""),
    md("""## Inspecting the posterior

Trained parameters live in `infr.params`, indexable by Variable
(transformations applied automatically)."""),
    code("""
mu_post = infr.params[q.mu.factor.mean].flatten()[0].item()
s_post = infr.params[m.s].flatten()[0].item()
print("posterior mean: {:.3f} (data mean {:.3f})".format(mu_post,
                                                         y.mean()))
print("noise variance: {:.3f} (data var {:.3f})".format(s_post,
                                                        y.var()))
"""),
    md("""## Posterior predictive sampling

`VariationalPosteriorForwardSampling` draws latents from the fitted
posterior and pushes them through the generative model."""),
    code("""
from mxfusion_tpu_torch.inference import VariationalPosteriorForwardSampling

fwd = VariationalPosteriorForwardSampling(
    num_samples=200, observed=[], inherited_inference=infr,
    target_variables=[m.y])
(samples,) = fwd.run(generator=torch.Generator(device).manual_seed(1))
print("predictive sample mean: {:.3f}".format(samples.mean().item()))
"""),
]

# ---------------------------------------------------------------- 2
NOTEBOOKS["gp_regression.ipynb"] = [
    md("""# Exact Gaussian-process regression

Fit an RBF-kernel GP to noisy observations of `sin(x)` by maximizing
the collapsed marginal likelihood, then predict at test inputs —
the counterpart of the reference's `gp_regression.ipynb`. On the card
the RBF gram is built by the port's hand-written CUDA kernel (K1,
`mxfusion_tpu_torch/csrc/rbf_gram.cu`): Kxx once a training step and
Kxt for the prediction. The Cholesky and the solves are PyTorch's, and
the products that feed them are pinned to IEEE float32 (TF32 kernel
matrices would make the Cholesky fail — the framework pins these paths
for you).
""" + CPU_OUTPUTS),
    code("""
import numpy as np

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import GPRegression
from mxfusion_tpu_torch.inference import (
    GradBasedInference, MAP, ModulePredictionAlgorithm,
    TransferInference, BatchInferenceLoop)

N = 60
rng = np.random.default_rng(0)
X = rng.random((N, 1)) * 4
Y = np.sin(X) + rng.standard_normal((N, 1)) * 0.1
"""),
    md("""## Model

`GPRegression` is a Module: a factor-graph node whose log-density is
the collapsed GP marginal likelihood. `m.N` is a symbolic dimension,
bound to the data's size when the inference runs."""),
    code("""
m = Model()
m.N = Variable()
m.X = Variable(shape=(m.N, 1))
m.noise_var = Variable(transformation=PositiveTransformation(),
                       initial_value=0.1)
m.Y = GPRegression.define_variable(
    X=m.X, kernel=RBF(input_dim=1, variance=1., lengthscale=1.),
    noise_var=m.noise_var, shape=(m.N, 1))
"""),
    md("""## Hyperparameter fitting

MAP over the module maximizes the marginal likelihood. It draws
nothing: every start is stated, so the fit is deterministic. The
`metrics_callback` receives per-step metrics (the loss, the gradient's
global norm and the step's wall time on the host)."""),
    code("""
history = []
loop = BatchInferenceLoop(
    metrics_callback=lambda i, mtr: history.append(mtr))
infr = GradBasedInference(
    inference_algorithm=MAP(model=m, observed=[m.X, m.Y]),
    grad_loop=loop)
infr.run(max_iter=300, learning_rate=0.05, X=X, Y=Y)

kernel = m.Y.factor._module_graph.kernel
print("lengthscale: {:.3f}, variance: {:.3f}, noise: {:.4f}".format(
    infr.params[kernel.lengthscale].flatten()[0].item(),
    infr.params[kernel.variance].flatten()[0].item(),
    infr.params[m.noise_var].flatten()[0].item()))
"""),
    md("""## Prediction

`TransferInference` carries the trained parameters into a prediction
algorithm; the posterior Cholesky computed during training is cached
and reused. For serving (requests cut into fixed-size chunks, one K1
launch for each chunk's gram on the card), see
`mxfusion_tpu_torch.inference.BatchedPredictor`."""),
    code("""
Xt = np.linspace(0, 4, 20)[:, None]
pred = TransferInference(ModulePredictionAlgorithm(
    model=m, observed=[m.X], target_variables=[m.Y.uuid]),
    infr_params=infr.params)
mu, var = pred.run(X=Xt)[0]
print("predictive mean abs error vs sin(x): {:.4f}".format(
    np.abs(mu[0].cpu().numpy() - np.sin(Xt)).mean()))
"""),
]

# ---------------------------------------------------------------- 3
NOTEBOOKS["svgp_regression.ipynb"] = [
    md("""# Stochastic variational GP regression

Scalable GP regression with the uncollapsed Hensman ELBO: explicit
`q(U)` variational parameters over inducing points, minibatch SVI —
the counterpart of the reference's `svgp_regression.ipynb`. This is
the production path: minibatches keep the per-step cost `O(M^2 B)`.
On the card K1 builds Kuu; the minibatch's `L^-1 Kuf` and its backward
are the port's fused kernels K2 and K3
(`mxfusion_tpu_torch/csrc/fused_gram.cu`, TF32 tensor cores) wherever
their gate admits the shapes, and K1 builds Kuf where it does not. A
`DeviceMinibatchLoop` keeps the whole dataset on the card (see
`examples/torch/svgp_large_scale.py`).
""" + CPU_OUTPUTS),
    code("""
import numpy as np
import torch

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import get_default_device
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import SVGPRegression
from mxfusion_tpu_torch.inference import (
    GradBasedInference, MAP, MinibatchInferenceLoop,
    ModulePredictionAlgorithm, TransferInference)

device = get_default_device()   # the card unless the CPU was asked for
N, BATCH, M_INDUCING = 2000, 100, 20
rng = np.random.default_rng(0)
X = rng.random((N, 1)) * 4
Y = np.sin(X) + rng.standard_normal((N, 1)) * 0.1
"""),
    md("""## Model with inducing inputs

The inducing inputs are a trainable `(M, 1)` Variable; `q(U)` (mean
and covariance factors) is created inside the module's posterior
graph. `whitened=True` is also available for the GPflow-style
whitened parameterization."""),
    code("""
m = Model()
m.N = Variable()
m.X = Variable(shape=(m.N, 1))
m.noise_var = Variable(transformation=PositiveTransformation(),
                       initial_value=0.1)
Z0 = np.linspace(0, 4, M_INDUCING)[:, None]
m.Y = SVGPRegression.define_variable(
    X=m.X, kernel=RBF(input_dim=1, variance=1., lengthscale=1.),
    noise_var=m.noise_var, shape=(m.N, 1),
    inducing_inputs=Variable(shape=(M_INDUCING, 1),
                             initial_value=Z0))
"""),
    md("""## Minibatch SVI

`rv_scaling = N / BATCH` makes each minibatch loss an unbiased
estimator of the full ELBO. Every batch has the same shape (the last
one of an epoch rolls over to its start); the host's native batcher
shuffles each epoch and gathers its rows, and each batch goes to the
device in one copy. `q(U)`'s starting values come from the generator."""),
    code("""
loop = MinibatchInferenceLoop(batch_size=BATCH,
                              rv_scaling={m.Y: N / BATCH})
infr = GradBasedInference(
    inference_algorithm=MAP(model=m, observed=[m.X, m.Y]),
    grad_loop=loop)
infr.run(max_iter=60, learning_rate=0.05, X=X, Y=Y,
         generator=torch.Generator(device).manual_seed(0))
"""),
    md("""## Prediction"""),
    code("""
Xt = np.linspace(0, 4, 20)[:, None]
pred = TransferInference(ModulePredictionAlgorithm(
    model=m, observed=[m.X], target_variables=[m.Y.uuid]),
    infr_params=infr.params)
mu, var = pred.run(X=Xt)[0]
print("predictive mean abs error vs sin(x): {:.4f}".format(
    np.abs(mu[0].cpu().numpy() - np.sin(Xt)).mean()))
"""),
    md("""## Where to go next

* `examples/torch/svgp_large_scale.py` — the 10^6-point workload with
  the dataset resident on the card (`DeviceMinibatchLoop`), then
  served over a mesh.
* `mxfusion_tpu_torch.inference.NaturalGradientLoop` — natural-gradient
  updates on `q(U)` (`examples/torch/svgp_natural_gradient.py`).
* `mxfusion_tpu_torch.parallel` — data-parallel SVI over
  `torch.distributed`.
* `docs/migrating_from_mxfusion.md` — the API mapping from the
  reference framework."""),
]

# ---------------------------------------------------------------- 4
NOTEBOOKS["ppca_tutorial.ipynb"] = [
    md("""# Probabilistic PCA

Learn a 2-D latent representation of 5-D synthetic data with
probabilistic PCA trained by reparameterized SVI — the counterpart of
the reference's `ppca_tutorial.ipynb` (and the first BASELINE.json
ladder config). The latents get a meanfield Normal posterior; the
loading matrix and noise are point-estimated (MAP-style) alongside.
""" + CPU_OUTPUTS),
    code("""
import numpy as np
import torch

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import get_default_device
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions.operators import (broadcast_to,
                                                               dot)
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference,
    create_Gaussian_meanfield)

device = get_default_device()   # the card unless the CPU was asked for
N, K, D = 100, 2, 5
rng = np.random.default_rng(0)
w_true = rng.standard_normal((K, D))
z_true = rng.standard_normal((N, K))
x = z_true @ w_true + rng.standard_normal((N, D)) * 0.1
"""),
    md("""## Model

`m.z` are the per-point latents with standard-Normal priors; `dot`
(a deterministic operator factor) projects them through the loading
matrix `m.w`; the observations are Normal around that projection.
Every operator is a factor-graph node, so the whole generative
density is one walk of the graph."""),
    code("""
m = Model()
m.w = Variable(shape=(K, D),
               initial_value=rng.standard_normal((K, D)) * 0.1)
m.z = Normal.define_variable(
    mean=broadcast_to(Variable(value=0.), (N, K)),
    variance=broadcast_to(Variable(value=1.), (N, K)),
    shape=(N, K))
m.x_mean = dot(m.z, m.w)
m.noise = Variable(transformation=PositiveTransformation(),
                   initial_value=0.1)
m.x = Normal.define_variable(mean=m.x_mean,
                             variance=broadcast_to(m.noise, (N, D)),
                             shape=(N, D))
"""),
    md("""## Meanfield SVI

`create_Gaussian_meanfield` builds the posterior graph over every
unobserved random variable (here: `z`). Each step draws the 5-sample
reparameterized ELBO estimate from the generator, differentiates it by
autograd and takes an Adam step on the device."""),
    code("""
q = create_Gaussian_meanfield(model=m, observed=[m.x])
alg = StochasticVariationalInference(num_samples=5, model=m,
                                     posterior=q, observed=[m.x])
infr = GradBasedInference(inference_algorithm=alg)
losses = []
infr.run(max_iter=1500, learning_rate=0.05, x=x,
         callback=lambda i, l: losses.append(float(l)),
         generator=torch.Generator(device).manual_seed(0))
print("loss: {:.1f} -> {:.1f}".format(losses[0], losses[-1]))
"""),
    md("""## Reconstruction

The posterior mean of `z` times the learned loading matrix should
reproduce the data up to the noise floor (~0.1)."""),
    code("""
z_post = infr.params[q.z.factor.mean].detach().cpu().numpy().reshape(N, K)
w_post = infr.params[m.w].detach().cpu().numpy().reshape(K, D)
recon = z_post @ w_post
print("mean reconstruction error: {:.3f}".format(
    np.abs(recon - x).mean()))
"""),
]

# ---------------------------------------------------------------- 5
NOTEBOOKS["bnn_regression.ipynb"] = [
    md("""# Bayesian neural-network regression

A `torch.nn` MLP with Normal priors over all weights, trained with
meanfield SVI; predictions by sampling the weight posterior — the
counterpart of the reference's `bnn_regression.ipynb` (which wraps a
Gluon block; here `NNFunction` wraps any `torch.nn.Module` as a
factor-graph function, and the per-sample evaluation is a
`torch.func.vmap`, not a loop).
""" + CPU_OUTPUTS),
    code('''
import numpy as np
import torch
from torch import nn

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import get_default_device
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions import NNFunction
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference,
    create_Gaussian_meanfield, VariationalPosteriorForwardSampling)

device = get_default_device()   # the card unless the CPU was asked for
N = 80
rng = np.random.default_rng(0)
X = np.sort(rng.uniform(-3, 3, (N, 1)), axis=0)
Y = np.sin(X) + rng.standard_normal((N, 1)) * 0.1


class MLP(nn.Module):
    def __init__(self, d_in, d_out, hidden=16):
        super().__init__()
        self.hidden = nn.Linear(d_in, hidden)
        self.out = nn.Linear(hidden, d_out)

    def forward(self, x):
        return self.out(torch.tanh(self.hidden(x)))
''' + LECUN_NORMAL),
    md("""## Model: priors over network weights

`NNFunction` lifts the MLP into the graph; its parameters become
latent Variables, and `set_prior` attaches a standard-Normal prior to
each (shapes broadcast automatically). The network starts from an
explicit generator; as its weights are latent, what SVI starts from is
q's means, which the inference's generator draws."""),
    code("""
net = NNFunction(lecun_normal_(MLP(1, 1), torch.Generator().manual_seed(0)),
                 name="f", input_shapes=[(N, 1)])
m = Model()
m.x = Variable(shape=(N, 1))
m.r = net(m.x)
for v in net.parameters.values():
    v.set_prior(Normal(mean=broadcast_to(Variable(value=0.), v.shape),
                       variance=broadcast_to(Variable(value=1.),
                                             v.shape)))
m.noise = Variable(transformation=PositiveTransformation(),
                   initial_value=0.01)
m.y = Normal.define_variable(mean=m.r,
                             variance=broadcast_to(m.noise, (N, 1)),
                             shape=(N, 1))
"""),
    md("""## Meanfield SVI over the weights"""),
    code("""
q = create_Gaussian_meanfield(model=m, observed=[m.x, m.y])
alg = StochasticVariationalInference(num_samples=5, model=m,
                                     posterior=q,
                                     observed=[m.x, m.y])
infr = GradBasedInference(inference_algorithm=alg)
losses = []
infr.run(max_iter=800, learning_rate=0.02, x=X, y=Y,
         callback=lambda i, l: losses.append(float(l)),
         generator=torch.Generator(device).manual_seed(0))
print("loss: {:.1f} -> {:.1f}".format(losses[0], losses[-1]))
"""),
    md("""## Posterior predictive

`VariationalPosteriorForwardSampling` draws weights from the fitted
posterior and pushes each draw through the network (vectorized over
the sample axis)."""),
    code("""
fwd = VariationalPosteriorForwardSampling(
    num_samples=100, observed=[m.x], inherited_inference=infr,
    target_variables=[m.y])
(samples,) = fwd.run(x=X, generator=torch.Generator(device).manual_seed(1))
pred_mean = samples.mean(0).cpu().numpy()
print("posterior predictive mean abs error vs sin(x): {:.3f}".format(
    np.abs(pred_mean - np.sin(X)).mean()))
"""),
]

# ---------------------------------------------------------------- 6
NOTEBOOKS["bnn_classification.ipynb"] = [
    md("""# Bayesian neural-network classification

Two-moons binary classification with a Categorical likelihood over
MLP logits and Normal priors on the weights — the counterpart of the
reference's `bnn_classification.ipynb`.
""" + CPU_OUTPUTS),
    code('''
import numpy as np
import torch
from torch import nn

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import get_default_device
from mxfusion_tpu_torch.components.distributions import Normal, Categorical
from mxfusion_tpu_torch.components.functions import NNFunction
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference,
    create_Gaussian_meanfield)

device = get_default_device()   # the card unless the CPU was asked for
rng = np.random.default_rng(0)
n_half = 50
t = rng.uniform(0, np.pi, n_half)
upper = np.stack([np.cos(t), np.sin(t)], -1)
lower = np.stack([1 - np.cos(t), -np.sin(t) + 0.5], -1)
X = np.concatenate([upper, lower]) + rng.standard_normal(
    (2 * n_half, 2)) * 0.1
Y = np.concatenate([np.zeros(n_half), np.ones(n_half)])[:, None]
n = len(X)


class MLP(nn.Module):
    def __init__(self, d_in, d_out, hidden=16):
        super().__init__()
        self.hidden = nn.Linear(d_in, hidden)
        self.out = nn.Linear(hidden, d_out)

    def forward(self, x):
        return self.out(torch.tanh(self.hidden(x)))
''' + LECUN_NORMAL),
    md("""## Model

The network emits per-class scores; `Categorical` consumes them as
(normalized-inside) log-probabilities. Weight priors are standard
Normals, as in the regression tutorial."""),
    code("""
net = NNFunction(lecun_normal_(MLP(2, 2), torch.Generator().manual_seed(0)),
                 name="f", input_shapes=[(n, 2)])
m = Model()
m.x = Variable(shape=(n, 2))
m.r = net(m.x)
for v in net.parameters.values():
    v.set_prior(Normal(mean=broadcast_to(Variable(value=0.), v.shape),
                       variance=broadcast_to(Variable(value=1.),
                                             v.shape)))
m.y = Categorical.define_variable(log_prob=m.r, num_classes=2,
                                  shape=(n, 1))
"""),
    md("""## Meanfield SVI"""),
    code("""
q = create_Gaussian_meanfield(model=m, observed=[m.x, m.y])
alg = StochasticVariationalInference(num_samples=5, model=m,
                                     posterior=q,
                                     observed=[m.x, m.y])
infr = GradBasedInference(inference_algorithm=alg)
losses = []
infr.run(max_iter=600, learning_rate=0.02, x=X, y=Y,
         callback=lambda i, l: losses.append(float(l)),
         generator=torch.Generator(device).manual_seed(0))
print("loss: {:.1f} -> {:.1f}".format(losses[0], losses[-1]))
"""),
    md("""## Decision quality at the posterior mean

Evaluate the network at the posterior-mean weights (`q[v]` indexes
the posterior graph by the model's weight variable)."""),
    code("""
params = {name: infr.params[q[v].factor.mean].detach().reshape(v.shape)
          for name, v in net.parameters.items()}
with torch.no_grad():
    logits = net.eval(params, f_input_0=torch.as_tensor(
        X, dtype=torch.float32, device=device))
acc = float((logits.argmax(-1).cpu().numpy() == Y[:, 0]).mean())
print("train accuracy with posterior-mean weights: {:.3f}".format(acc))
"""),
]

# ---------------------------------------------------------------- 7
NOTEBOOKS["variational_auto_encoder.ipynb"] = [
    md("""# Variational auto-encoder

A `torch.nn` decoder inside the generative model and a `torch.nn`
encoder inside the variational posterior — amortized inference trained
end-to-end by reparameterized SVI. Counterpart of the reference's
`variational_auto_encoder.ipynb`.
""" + CPU_OUTPUTS),
    code('''
import numpy as np
import torch
from torch import nn

from mxfusion_tpu_torch import Model, Posterior, Variable
from mxfusion_tpu_torch.common.config import get_default_device
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions import NNFunction
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference)

device = get_default_device()   # the card unless the CPU was asked for
N, D, K = 100, 8, 2
rng = np.random.default_rng(0)
z_true = rng.standard_normal((N, K))
proj = rng.standard_normal((K, D))
x = np.tanh(z_true @ proj) + rng.standard_normal((N, D)) * 0.05


class Decoder(nn.Module):
    def __init__(self, latent, out, hidden=16):
        super().__init__()
        self.hidden = nn.Linear(latent, hidden)
        self.out = nn.Linear(hidden, out)

    def forward(self, z):
        return self.out(torch.tanh(self.hidden(z)))


class Encoder(nn.Module):
    """x -> (mean, variance) of q(z | x)."""

    def __init__(self, data, latent, hidden=16):
        super().__init__()
        self.hidden = nn.Linear(data, hidden)
        self.mean = nn.Linear(hidden, latent)
        self.log_var = nn.Linear(hidden, latent)

    def forward(self, x):
        h = torch.tanh(self.hidden(x))
        return self.mean(h), torch.exp(self.log_var(h)) + 1e-6
''' + LECUN_NORMAL),
    md("""## Generative model: decoder inside the graph

The decoder's weights are parameters, not latents, so their start
matters: LeCun-normal from an explicit generator, as flax's Dense
layers start in the reference's tutorial."""),
    code("""
decoder = NNFunction(
    lecun_normal_(Decoder(K, D), torch.Generator().manual_seed(0)),
    name="dec", input_shapes=[(N, K)])
m = Model()
m.z = Normal.define_variable(
    mean=broadcast_to(Variable(value=0.), (N, K)),
    variance=broadcast_to(Variable(value=1.), (N, K)),
    shape=(N, K))
m.x_mean = decoder(m.z)
m.x = Normal.define_variable(
    mean=m.x_mean,
    variance=broadcast_to(Variable(value=0.01), (N, D)),
    shape=(N, D))
"""),
    md("""## Amortized posterior: encoder inside the Posterior graph

A `Posterior` replicates the model's variables; attaching the
encoder's outputs as `q(z)`'s mean/variance makes the variational
parameters a FUNCTION of the observed data (`num_outputs=2` splits
the module's tuple output into two graph variables)."""),
    code("""
encoder = NNFunction(
    lecun_normal_(Encoder(D, K), torch.Generator().manual_seed(1)),
    name="enc", input_shapes=[(N, D)], num_outputs=2)
q = Posterior(m)
q_mean, q_var = encoder(q.x)
q.z.set_prior(Normal(mean=q_mean, variance=q_var))
"""),
    md("""## Joint training

One SVI objective trains decoder weights (model side) and encoder
weights (posterior side) together."""),
    code("""
alg = StochasticVariationalInference(num_samples=3, model=m,
                                     posterior=q, observed=[m.x])
infr = GradBasedInference(inference_algorithm=alg)
losses = []
infr.run(max_iter=1000, learning_rate=0.01, x=x,
         callback=lambda i, l: losses.append(float(l)),
         generator=torch.Generator(device).manual_seed(0))
print("ELBO loss: {:.1f} -> {:.1f}".format(losses[0], losses[-1]))
"""),
]

# ---------------------------------------------------------------- 8
NOTEBOOKS["writing_a_new_distribution.ipynb"] = [
    md("""# Writing a new distribution

Implement a Gumbel distribution — log-pdf plus reparameterized
sampling — and fit it by MAP, end-to-end. Counterpart of the
reference's `writing_a_new_distribution.ipynb`. (That notebook's
original exercise, an Exponential, already ships in
`mxfusion_tpu_torch.components.distributions`, so the tutorial builds
something genuinely new.)

A distribution needs three things:

1. `__init__` declaring its input parameters,
2. `log_pdf_impl` — plain torch on tensors that already carry the
   leading sample axis,
3. `draw_samples_impl` — sampling from the caller's `torch.Generator`
   through the distribution's random generator; use the inverse CDF
   (or another pathwise form) and gradients flow to the parameters
   automatically.

Declare `support` (`"real"`, `"positive"`, `"unit_interval"` or
`"simplex"`) so that MCMC, MAP and the meanfield posterior biject a
latent of this distribution onto its domain; the Gumbel lives on the
reals.
""" + CPU_OUTPUTS),
    code('''
import numpy as np
import torch

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions.distribution import \\
    UnivariateDistribution
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.inference import GradBasedInference, MAP


class Gumbel(UnivariateDistribution):
    """Gumbel(location, scale):
    log p(x) = -z - exp(-z) - log(scale), z = (x - location)/scale."""

    support = "real"

    def __init__(self, location, scale, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("location", location), ("scale", scale)],
            outputs=None,
            input_names=["location", "scale"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, location, scale):
        z = (random_variable - location) / scale
        return -z - torch.exp(-z) - torch.log(scale)

    def draw_samples_impl(self, rv_shape, num_samples, generator, location,
                          scale):
        u = self._rand_gen.sample_uniform(
            generator, shape=(num_samples,) + tuple(rv_shape),
            dtype=self.dtype)
        # inverse CDF, reparameterized: gradients flow to the params
        return location - scale * torch.log(-torch.log(u))

    @classmethod
    def define_variable(cls, location=0., scale=1., shape=None,
                        rand_gen=None, dtype=None):
        dist = cls(location=location, scale=scale, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
'''),
    md("""## Using it in a model

Nothing else is needed: the new distribution is a first-class factor.
Fit location and scale to 400 Gumbel draws by MAP (the positive scale
trains in softplus space via its transformation). MAP draws nothing
here, so the fit is deterministic."""),
    code("""
rng = np.random.default_rng(0)
true_loc, true_scale = 1.5, 0.8
y = rng.gumbel(true_loc, true_scale, (400, 1))

m = Model()
m.loc = Variable(initial_value=0.0)
m.scale = Variable(transformation=PositiveTransformation(),
                   initial_value=1.0)
m.y = Gumbel.define_variable(
    location=broadcast_to(m.loc, (400, 1)),
    scale=broadcast_to(m.scale, (400, 1)), shape=(400, 1))

infr = GradBasedInference(
    inference_algorithm=MAP(model=m, observed=[m.y]))
infr.run(max_iter=400, learning_rate=0.1, y=y)
print("MLE location: {:.3f} (true {})".format(
    infr.params[m.loc].flatten()[0].item(), true_loc))
print("MLE scale:    {:.3f} (true {})".format(
    infr.params[m.scale].flatten()[0].item(), true_scale))
"""),
    md("""## Where to go next

* `examples/torch/writing_a_new_module.py` — the same exercise one
  level up: a new Module with its own inference algorithms.
* `tests/test_torch_distributions.py` — the moment-test pattern for
  validating a new distribution's sampler.
* `docs/design_documents/distributions.md` — the reference's design of
  the distribution layer (sample-axis conventions, support
  declarations, bijectors), which the port keeps."""),
]

# ---------------------------------------------------------------- 9
NOTEBOOKS["deep_gp.ipynb"] = [
    md("""# Deep Gaussian processes

Stack SVGP layers and train them jointly by doubly-stochastic
variational inference (Salimbeni & Deisenroth, 2017) — a capability
beyond the reference framework's module set. The target is a step
function: a stationary single-layer RBF GP smooths the jump, while the
2-layer stack learns an input warp that sharpens it.

Device notes: the Monte-Carlo propagation samples ride the framework's
leading sample axis, so each layer is ONE batched evaluation over an
`(S, N, D)` block. On the card K1 builds each layer's Kuu and Kuf (the
second layer's Kuf for all S samples in one launch), followed by
batched triangular solves and products. The final layer's Gaussian
expected log-likelihood is analytic, so a 1-layer `DeepGPRegression`
reproduces the SVGP ELBO exactly.
""" + CPU_OUTPUTS),
    code("""
import numpy as np
import torch

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.common.config import get_default_device
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.modules import DeepGPRegression
from mxfusion_tpu_torch.inference import (
    GradBasedInference, MAP, ModulePredictionAlgorithm,
    TransferInference)

device = get_default_device()   # the card unless the CPU was asked for
N = 120
rng = np.random.default_rng(0)
X = np.sort(rng.random((N, 1)) * 4, axis=0)
truth = np.where(X > 2.0, 1.0, -1.0)
Y = truth + rng.standard_normal((N, 1)) * 0.05
"""),
    md("""## Model

One kernel per layer; layer widths follow the NEXT kernel's
`input_dim` (the final layer outputs Y's event width). Inner layers
carry fixed identity-like linear mean maps (the standard skip
connection that keeps the signal path open at initialization), the
whitened parameterization is the default, and `jitter` is RELATIVE to
each layer's kernel scale — deep training grows those scales
freely."""),
    code("""
m = Model()
m.n = Variable()
m.X = Variable(shape=(m.n, 1))
m.noise_var = Variable(transformation=PositiveTransformation(),
                       initial_value=0.1)
Z0 = np.linspace(0.2, 3.8, 8)[:, None]
Z1 = np.linspace(-1.2, 1.2, 8)[:, None]
m.Y = DeepGPRegression.define_variable(
    X=m.X, kernels=[RBF(input_dim=1), RBF(input_dim=1)],
    noise_var=m.noise_var, shape=(m.n, 1),
    inducing_inputs=[Variable(shape=Z0.shape, initial_value=Z0),
                     Variable(shape=Z1.shape, initial_value=Z1)],
    jitter=1e-5, num_samples=3)
"""),
    md("""## Training

MAP over the module maximizes the doubly-stochastic ELBO (the S=3
propagation samples average inside the loss); the samples and `q(U)`'s
starting values come from the generator."""),
    code("""
infr = GradBasedInference(
    inference_algorithm=MAP(model=m, observed=[m.X, m.Y]))
losses = []
infr.run(max_iter=300, learning_rate=0.02, X=X, Y=Y,
         callback=lambda i, l: losses.append(float(l)),
         generator=torch.Generator(device).manual_seed(0))
print("loss: {:.1f} -> {:.1f}".format(losses[0], losses[-1]))
"""),
    md("""## Prediction

`predict` returns the Gaussian-mixture moments over the propagation
samples. An UNSET sample count uses the module's default (20); pass
`num_samples=...` to control the cost/variance trade-off explicitly
(an explicit 1 is honored as a cheap point estimate). The 50 samples
here come from the generator passed to `run`."""),
    code("""
pred = TransferInference(ModulePredictionAlgorithm(
    model=m, observed=[m.X], target_variables=[m.Y.uuid],
    num_samples=50), infr_params=infr.params)
mu, var = pred.run(X=X, generator=torch.Generator(device).manual_seed(1))[0]
rmse = float(np.sqrt(np.mean((mu[0].cpu().numpy() - truth) ** 2)))
print("RMSE vs the noiseless step: {:.3f}".format(rmse))
"""),
    md("""## Where to go next

* `DeepGPClassification` — the same stack with a Bernoulli likelihood
  (Gauss–Hermite expected log-likelihood, logit/probit links).
* `examples/torch/deep_gp_regression.py` — this workload against a
  single-layer SVGP baseline.
* Serving: `BatchedPredictor` chunks deep-GP prediction like any
  other module (the mixture moments declare their serving axes)."""),
]


def run_cells(nb, name="notebook"):
    """Execute ``nb``'s code cells in order in one namespace; return the
    namespace and each code cell's captured standard output."""
    ns = {"__name__": "__notebook__"}
    outputs = []
    count = 0
    for cell in nb["cells"]:
        if cell["cell_type"] != "code":
            continue
        count += 1
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            exec(compile("".join(cell["source"]),
                         "{}[{}]".format(name, count), "exec"), ns)
        outputs.append(buf.getvalue())
    return ns, outputs


def execute_notebook(path):
    """Run every code cell of the notebook at ``path`` in one namespace
    and embed the captured standard output as its executed outputs."""
    import torch
    with open(path) as f:
        nb = json.load(f)
    torch.manual_seed(0)
    _, outputs = run_cells(nb, os.path.basename(path))
    cells = [c for c in nb["cells"] if c["cell_type"] == "code"]
    for count, (cell, text) in enumerate(zip(cells, outputs), 1):
        cell["execution_count"] = count
        cell["outputs"] = ([{"name": "stdout", "output_type": "stream",
                             "text": text.splitlines(keepends=True)}]
                           if text else [])
    with open(path, "w") as f:
        json.dump(nb, f, indent=1)
        f.write("\n")
    print("executed", path)


def main(argv):
    out_dir = HERE
    if "--out" in argv:
        out_dir = argv[argv.index("--out") + 1]
    os.makedirs(out_dir, exist_ok=True)
    paths = [write(out_dir, name, copy.deepcopy(cells))
             for name, cells in NOTEBOOKS.items()]
    if "--execute" in argv:
        sys.path.insert(0, ROOT)
        import torch
        from mxfusion_tpu_torch.common.config import set_default_device
        set_default_device("cpu")
        torch.set_num_threads(1)
        for path in paths:
            execute_notebook(path)


if __name__ == "__main__":
    main(sys.argv[1:])
