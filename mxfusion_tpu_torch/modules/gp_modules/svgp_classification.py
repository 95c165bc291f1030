"""Stochastic variational GP binary classification.

Counterpart of ``mxfusion_tpu/modules/gp_modules/svgp_classification.py``.
The uncollapsed SVGP posterior ``q(U) = N(qU_mean, qU_cov_W qU_cov_Wᵀ +
diag(qU_cov_diag))`` with a Bernoulli likelihood whose expected
log-likelihood is a fixed-order Gauss-Hermite quadrature over the
diagonal moments of q(f) (Hensman, Matthews & Ghahramani 2015): one
(s, N, Q) broadcast, minibatchable like the regression bound.

``jitter`` here is RELATIVE (times the mean of Kuu's diagonal): training
grows the kernel variance with no noise parameter to balance it, and a
float32 Cholesky needs a stabilizer that tracks Kuu's scale.

The moment helpers (``_layer_q_moments``, ``_q_f_moments``, ``_neg_kl``,
``_gauss_hermite``, ``_bernoulli_expected_log_lik``,
``_class_probability``) are the single copy that the count and
multi-class modules share, as in the JAX package. On the card, Kuu and
Kuf (RBF, float32) are K1 launches through ``RBF.K``.
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..module import Module
from ...models.model import Model
from ...models.posterior import Posterior
from ...components.variables.variable import Variable
from ...components.variables.var_trans import PositiveTransformation
from ...components.variables.runtime_variable import arrays_as_samples
from ...components.distributions.bernoulli import Bernoulli
from ...components.distributions.gp.gp import GaussianProcess
from ...components.distributions.gp.cond_gp import \
    ConditionalGaussianProcess
from ...components.functions.operators import sigmoid, probit
from ...inference.variational import VariationalInference
from ...inference.inference_alg import SamplingAlgorithm
from ...inference.forward_sampling import ForwardSamplingAlgorithm
from ...ops.linalg import (cholesky, make_diagonal, triangular_inverse,
                           wide_triangular_solve)
from ...ops.precision import einsum as p_einsum
from ...ops.precision import guarded_forward_matmul


# latent-variance floor for the quadrature's sqrt: a positive floor, not
# 0, whose derivative is finite; far below any meaningful q(f) variance
_VAR_FLOOR = 1e-14


@functools.lru_cache(maxsize=None)
def _gauss_hermite(num_points, dtype, device=None):
    """(nodes, weights) for E_{f~N(m,v)}[g(f)] ≈ Σ w_i g(m + √(2v) t_i),
    the 1/√π folded into the weights; one copy per dtype and device."""
    t, w = np.polynomial.hermite.hermgauss(num_points)
    return (torch.as_tensor(t, dtype=dtype, device=device),
            torch.as_tensor(w / np.sqrt(np.pi), dtype=dtype, device=device))


def _nodes(mu, var_safe, num_points):
    """The quadrature's (..., Q) nodes at moments (mu, var_safe), and its
    weights."""
    t, w = _gauss_hermite(num_points, mu.dtype, mu.device)
    return mu[..., None] + torch.sqrt(2.0 * var_safe)[..., None] * t, w


def _layer_q_moments(X, Z, mu, S_W, S_diag, kern, kern_params, jitter,
                     whitened, relative_jitter=True, mean_f=None):
    """Diagonal moments of one SVGP layer's q(F) at inputs ``X``, plus the
    whitened mean and covariance factors of the KL term. Every operand
    carries the sample axis already (``arrays_as_samples``).

    Returns (mu_f (s, N, D), var_f (s, N), Linvmu, LinvLs); var_f is
    column-shared (one q(U) covariance for all output columns).
    ``mean_f`` is an additive output mean, already broadcast.
    """
    M = Z.shape[-2]
    eye_m = torch.eye(M, dtype=Z.dtype, device=Z.device)[None]
    Kuu = kern.K(Z, **kern_params)
    if jitter > 0.0:
        if relative_jitter:
            # float32 Cholesky roundoff is about eps·‖Kuu‖: the margin
            # tracks Kuu's scale
            scale = torch.mean(torch.diagonal(Kuu, dim1=-2, dim2=-1),
                               dim=-1)[..., None, None]
            Kuu = Kuu + eye_m * (jitter * scale)
        else:
            Kuu = Kuu + eye_m * jitter
    Kuf = kern.K(Z, X, **kern_params)
    Kff_diag = kern.Kdiag(X, **kern_params)

    S = p_einsum("...ik,...jk->...ij", S_W, S_W) + make_diagonal(S_diag)
    # one batched Cholesky for the two independent M×M factors; a factor
    # that fails is NaN, as jnp.linalg.cholesky's
    LL = cholesky(torch.stack([Kuu, S], dim=-3))
    L = LL[..., 0, :, :]
    Ls = LL[..., 1, :, :]
    wide = Kuf.shape[-1] >= 4 * M
    Linv = triangular_inverse(L, lower=True) \
        if (wide and not whitened) else None
    if whitened:
        LinvLs = Ls
        Linvmu = mu
    elif Linv is not None:
        LinvLs = p_einsum("...ij,...jk->...ik", Linv, Ls)
        Linvmu = p_einsum("...ij,...jk->...ik", Linv, mu)
    else:
        LinvLs = torch.linalg.solve_triangular(L, Ls, upper=False)
        Linvmu = torch.linalg.solve_triangular(L, mu, upper=False)
    if Linv is not None:
        # forward floored at HIGH: L⁻¹Kuf feeds the var_f cancellation
        # (Kff − Σ(L⁻¹Kuf)²) below
        LinvKuf = guarded_forward_matmul(Linv, Kuf)
    else:
        # data samples against a sample-size-1 factor (the deep GP's
        # layers): broadcast the factor to the data panel's sample count
        L_b = L if L.shape[0] == Kuf.shape[0] else \
            torch.broadcast_to(L, Kuf.shape[:-2] + L.shape[-2:])
        LinvKuf = wide_triangular_solve(L_b, Kuf, lower=True)

    mu_f = p_einsum("...mn,...md->...nd", LinvKuf, Linvmu)
    if mean_f is not None:
        mu_f = mu_f + mean_f
    LsTLinvKuf = p_einsum("...mk,...mn->...kn", LinvLs, LinvKuf)
    var_f = Kff_diag \
        - torch.sum(torch.square(LinvKuf), dim=-2) \
        + torch.sum(torch.square(LsTLinvKuf), dim=-2)
    return mu_f, var_f, Linvmu, LinvLs


def _q_f_moments(env, model, posterior, jitter, whitened,
                 keep_columns=False):
    """Diagonal moments of q(F) at the model's X, plus the whitened mean
    and covariance factors of the KL term: (mu_f (s, N), var_f (s, N),
    Linvmu, LinvLs). ``keep_columns=True`` keeps mu_f as (s, N, D) for
    multi-column latents (multi-class); var_f is column-shared either
    way."""
    X = env[model.X]
    Z = env[model.inducing_inputs]
    mu = env[posterior.qU_mean]
    S_W = env[posterior.qU_cov_W]
    S_diag = env[posterior.qU_cov_diag]
    kern = model.kernel
    kern_params = kern.fetch_parameters(env)
    X, Z, mu, S_W, S_diag, kern_params = arrays_as_samples(
        [X, Z, mu, S_W, S_diag, kern_params])

    mean_f = None
    if model.F.factor.has_mean:
        (mean_f,) = arrays_as_samples([env[model.mean]])
    mu_f, var_f, Linvmu, LinvLs = _layer_q_moments(
        X, Z, mu, S_W, S_diag, kern, kern_params, jitter, whitened,
        relative_jitter=True, mean_f=mean_f)
    if not keep_columns:
        mu_f = mu_f[..., 0]
    return mu_f, var_f, Linvmu, LinvLs


def _neg_kl(Linvmu, LinvLs, num_columns):
    """−KL(q(U) ‖ p(U)) for ``num_columns`` latent GP columns sharing one
    q(U) covariance. The logdet terms collapse because diag(L⁻¹Ls) =
    diag(Ls)/diag(L); in whitened coordinates LinvLs is Ls."""
    M = Linvmu.shape[-2]
    sumlogdiag = torch.sum(torch.log(
        torch.diagonal(LinvLs, dim1=-2, dim2=-1)), dim=-1)
    return (M / 2.0 + sumlogdiag) * num_columns \
        - torch.sum(torch.square(LinvLs), dim=(-2, -1)) / 2.0 * num_columns \
        - torch.sum(torch.square(Linvmu), dim=(-2, -1)) / 2.0


def _bernoulli_expected_log_lik(mu, var_f, sign, link,
                                num_quadrature_points):
    """Gauss-Hermite E_{f~N(mu, var_f)}[log Bern(y | link(f))] per point;
    ``sign`` is 2y − 1, broadcastable against ``mu`` (s, N)."""
    # positive floor, not 0: sqrt'(0) is infinite, and whitened training
    # drives var_f slightly negative by cancellation
    var_safe = torch.clamp_min(var_f, _VAR_FLOOR)
    f, w = _nodes(mu, var_safe, num_quadrature_points)
    if link == "probit":
        log_lik = torch.special.log_ndtr(sign[..., None] * f)
    else:
        log_lik = F.logsigmoid(sign[..., None] * f)
    return torch.sum(log_lik * w, dim=-1)                     # (s, N)


def _class_probability(mu, var_f, link, num_quadrature_points):
    """Predictive p(y=1) = E_{f~N(mu, var_f)}[link(f)] per point: the
    quadrature for the logit link, the closed form Φ(μ/√(1+σ²)) for the
    probit link."""
    var_safe = torch.clamp_min(var_f, _VAR_FLOOR)
    if link == "probit":
        return torch.special.ndtr(mu / torch.sqrt(1.0 + var_safe))
    f, w = _nodes(mu, var_safe, num_quadrature_points)
    return torch.sum(torch.sigmoid(f) * w, dim=-1)            # (s, N)


def _labels_vs_moments(Y, s):
    """Labels with a sample axis of 1 broadcast to the moments' ``s``."""
    if Y.shape[0] != s:
        (Y,) = arrays_as_samples([Y])
        Y = Y.expand((s,) + tuple(Y.shape[1:]))
    return Y


class SVGPClassificationLogPdf(VariationalInference):
    """Quadrature ELBO: Σ_n E_{q(f_n)}[log Bern(y_n | link(f_n))] − KL.

    Labels are {0, 1}. ``link="logit"`` uses ``logsigmoid((2y−1) f)``,
    ``link="probit"`` uses ``log Φ((2y−1) f)``."""

    def __init__(self, model, posterior, observed, jitter=0.0,
                 whitened=False, num_quadrature_points=20,
                 link="logit"):
        super().__init__(num_samples=1, model=model, posterior=posterior,
                         observed=observed)
        self.log_pdf_scaling = 1.0
        self.jitter = jitter
        self.whitened = whitened
        self.num_quadrature_points = num_quadrature_points
        self.link = link

    def compute(self, env, ctx):
        mu_f, var_f, Linvmu, LinvLs = _q_f_moments(
            env, self.model, self.posterior, self.jitter, self.whitened)
        Y = _labels_vs_moments(env[self.model.Y], mu_f.shape[0])
        D = Linvmu.shape[-1]

        sign = 2.0 * Y[..., 0] - 1.0                          # (s, N)
        quad = _bernoulli_expected_log_lik(
            mu_f, var_f, sign, self.link, self.num_quadrature_points)
        logL = torch.sum(quad, dim=-1)
        return self.log_pdf_scaling * logL + _neg_kl(Linvmu, LinvLs, D)


class SVGPClassificationProbPrediction(SamplingAlgorithm):
    """Predictive class-1 probability p(y*=1) = E_{q(f*)}[link(f*)]:
    quadrature for the logit link, the closed form for the probit link.
    Returns {Y: (p, p(1−p))}."""

    serving_data_axes = ((1,), (1,))  # (s, N, 1) probability moments

    def __init__(self, model, posterior, observed, jitter=0.0,
                 whitened=False, num_quadrature_points=20,
                 link="logit"):
        super().__init__(model=model, observed=observed,
                         extra_graphs=[posterior])
        self.jitter = jitter
        self.whitened = whitened
        self.num_quadrature_points = num_quadrature_points
        self.link = link

    def compute(self, env, ctx):
        posterior = self._extra_graphs[0]
        mu_f, var_f, _, _ = _q_f_moments(
            env, self.model, posterior, self.jitter, self.whitened)
        p = _class_probability(mu_f, var_f, self.link,
                               self.num_quadrature_points)[..., None]
        outcomes = {self.model.Y.uuid: (p, p * (1.0 - p))}
        if self.target_variables:
            return tuple(outcomes[v] for v in self.target_variables)
        return outcomes


class SVGPClassification(Module):
    """SVGP binary classification module: ``log_pdf`` is the quadrature
    ELBO, ``predict`` the class probability, sampling walks the
    generative graph U → F → link(F) → Bernoulli."""

    #: the bound's data term is a sum over rows (the KL is global)
    row_separable = True

    def __init__(self, X, kernel, inducing_inputs=None, num_inducing=10,
                 mean=None, rand_gen=None, dtype=None, jitter=1e-5,
                 whitened=False, num_quadrature_points=20, link="logit"):
        if link not in ("logit", "probit"):
            raise ValueError("link must be 'logit' or 'probit', got "
                             "{!r}".format(link))
        self.jitter = jitter
        self.whitened = whitened
        self.num_quadrature_points = num_quadrature_points
        self.link = link
        if not isinstance(X, Variable):
            X = Variable(value=X)
        if inducing_inputs is None:
            inducing_inputs = Variable(
                shape=(num_inducing, kernel.input_dim),
                initial_value=np.random.randn(num_inducing,
                                              kernel.input_dim))
        inputs = [("X", X), ("inducing_inputs", inducing_inputs)]
        input_names = [k for k, _ in inputs]
        if mean is not None:
            inputs.append(("mean", mean))
            input_names.append("mean")
            self._has_mean = True
        else:
            self._has_mean = False
        super().__init__(inputs=inputs, outputs=None,
                         input_names=input_names,
                         output_names=["random_variable"],
                         rand_gen=rand_gen, dtype=dtype)
        self.kernel = kernel

    def _generate_outputs(self, output_shapes=None):
        if output_shapes["random_variable"] is None:
            Y_shape = self.X.shape[:-1] + (1,)
        else:
            Y_shape = output_shapes["random_variable"]
        if Y_shape[-1] != 1:
            raise ValueError(
                "SVGPClassification is binary: the output event dim "
                "must be 1, got {}. Use one module per one-vs-rest "
                "class for multi-class.".format(Y_shape[-1]))
        self.set_outputs([Variable(shape=Y_shape)])

    def _build_module_graphs(self):
        Y = self.random_variable
        graph = Model(name="svgp_classification")
        graph.X = self.X.replicate_self()
        graph.inducing_inputs = self.inducing_inputs.replicate_self()
        M = self.inducing_inputs.shape[0]
        graph.U = GaussianProcess.define_variable(
            X=graph.inducing_inputs, kernel=self.kernel,
            shape=(graph.inducing_inputs.shape[0], Y.shape[-1]),
            rand_gen=self._rand_gen, dtype=self.dtype, jitter=self.jitter)
        mean = None
        if self._has_mean:
            graph.mean = self.mean.replicate_self()
            mean = graph.mean
        graph.F = ConditionalGaussianProcess.define_variable(
            X=graph.X, X_cond=graph.inducing_inputs, Y_cond=graph.U,
            kernel=self.kernel, shape=Y.shape, mean=mean,
            rand_gen=self._rand_gen, dtype=self.dtype, jitter=self.jitter)
        graph.p = sigmoid(graph.F) if self.link == "logit" \
            else probit(graph.F)
        graph.Y = Y.replicate_self()
        graph.Y.set_prior(Bernoulli(
            prob_true=graph.p, rand_gen=self._rand_gen, dtype=self.dtype))
        graph.kernel = graph.U.factor.kernel
        post = Posterior(graph)
        post.qU_cov_diag = Variable(
            shape=(M,), transformation=PositiveTransformation(),
            initial_value=np.ones(M) * 1e-6)
        post.qU_cov_W = Variable(shape=(M, M), initial_value=np.eye(M))
        post.qU_mean = Variable(shape=(M, Y.shape[-1]))
        return graph, [post]

    def _attach_default_inference_algorithms(self):
        observed = [v for _, v in self.inputs] + \
            [v for _, v in self.outputs]
        self.attach_log_pdf_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=SVGPClassificationLogPdf(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened,
                num_quadrature_points=self.num_quadrature_points,
                link=self.link),
            alg_name="svgp_class_log_pdf")
        observed = [v for _, v in self.inputs]
        self.attach_draw_samples_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=ForwardSamplingAlgorithm(self._module_graph,
                                               observed),
            alg_name="svgp_class_sampling")
        self.attach_prediction_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=SVGPClassificationProbPrediction(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened,
                num_quadrature_points=self.num_quadrature_points,
                link=self.link),
            alg_name="svgp_class_predict")

    @staticmethod
    def define_variable(X, kernel, shape=None, inducing_inputs=None,
                        num_inducing=10, mean=None, rand_gen=None,
                        dtype=None, jitter=1e-5, whitened=False,
                        num_quadrature_points=20, link="logit"):
        gp = SVGPClassification(
            X=X, kernel=kernel, inducing_inputs=inducing_inputs,
            num_inducing=num_inducing, mean=mean, rand_gen=rand_gen,
            dtype=dtype, jitter=jitter, whitened=whitened,
            num_quadrature_points=num_quadrature_points, link=link)
        gp._generate_outputs({"random_variable": shape})
        return gp.random_variable

    def replicate_self(self, attribute_map=None):
        rep = super().replicate_self(attribute_map)
        rep.kernel = self.kernel.replicate_self(attribute_map)
        if rep._module_graph is not None:
            rep._module_graph.kernel = rep._module_graph.U.factor.kernel
        rep._has_mean = self._has_mean
        rep.jitter = self.jitter
        rep.whitened = self.whitened
        rep.num_quadrature_points = self.num_quadrature_points
        rep.link = self.link
        return rep
