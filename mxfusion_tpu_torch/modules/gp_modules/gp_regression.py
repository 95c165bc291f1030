"""Exact Gaussian-process regression module.

Counterpart of ``mxfusion_tpu/modules/gp_modules/gp_regression.py``.
Internal model: ``F ~ GP(X, kernel)``, ``Y ~ Normal(F, noise_var)``; the
log-pdf algorithm computes the collapsed Gaussian marginal likelihood
with one Cholesky of the N × N noisy gram, and caches ``(X, L, LinvY)``
into the posterior graph through the aux write-back, which the
predictions read. On the card an RBF kernel builds Kxx (once per
training step) and Kxt (once per prediction chunk) with K1; the
Cholesky is ``ops.linalg.cholesky`` (JAX's NaN convention) and the
solves are ``torch.linalg.solve_triangular``.
"""
import math

import torch

from ..module import Module
from ...models.model import Model
from ...models.posterior import Posterior
from ...components.variables.variable import Variable
from ...components.variables.runtime_variable import arrays_as_samples
from ...components.distributions.normal import Normal
from ...components.distributions.gp.gp import GaussianProcess
from ...components.functions.operators import broadcast_to
from ...inference.variational import VariationalInference
from ...inference.inference_alg import SamplingAlgorithm
from ...util.inference import realize_shape
from ...ops.linalg import broadcast_to_w_samples, cholesky
from ...ops.precision import einsum as p_einsum
from ...ops.precision import data_precision_scope
from .svgp_regression import _solve_lower

LOG2PI = math.log(2.0 * math.pi)


def _noisy_K(kern, X, noise_var, kern_params, jitter=0.0):
    N = X.shape[-2]
    eye = torch.eye(N, dtype=X.dtype, device=X.device)
    K = kern.K(X, **kern_params) + eye * torch.unsqueeze(noise_var, -2)
    if jitter > 0.0:
        K = K + eye * jitter
    return K


class GPRegressionLogPdf(VariationalInference):
    """Collapsed log marginal likelihood."""

    def __init__(self, model, posterior, observed, jitter=0.0):
        super().__init__(num_samples=1, model=model, posterior=posterior,
                         observed=observed)
        self.log_pdf_scaling = 1.0
        self.jitter = jitter

    def compute(self, env, ctx):
        has_mean = self.model.F.factor.has_mean
        X = env[self.model.X]
        Y = env[self.model.Y]
        noise_var = env[self.model.noise_var]
        D = Y.shape[-1]
        kern = self.model.kernel
        kern_params = kern.fetch_parameters(env)
        X, Y, noise_var, kern_params = arrays_as_samples(
            [X, Y, noise_var, kern_params])
        K = _noisy_K(kern, X, noise_var, kern_params, self.jitter)
        L = cholesky(K)
        if has_mean:
            Y = Y - env[self.model.mean]
        LinvY = _solve_lower(L, Y)
        logdet_l = torch.sum(torch.log(torch.abs(
            torch.diagonal(L, dim1=-2, dim2=-1))), dim=-1)
        tmp = torch.sum(torch.reshape(torch.square(LinvY) + LOG2PI,
                                      (Y.shape[0], -1)), dim=-1)
        logL = (-logdet_l * D - tmp / 2.0) * self.log_pdf_scaling
        # the prediction cache: sample 0, as in JAX
        self.set_parameter(ctx, self.posterior.X, X[0])
        self.set_parameter(ctx, self.posterior.L, L[0])
        self.set_parameter(ctx, self.posterior.LinvY, LinvY[0])
        return logL


class GPRegressionSampling(SamplingAlgorithm):
    """Prior sampling: ``L·ε`` with L the factor of the noisy gram."""

    def __init__(self, model, observed, num_samples=1, target_variables=None,
                 rand_gen=None, jitter=0.0):
        super().__init__(model=model, observed=observed,
                         num_samples=num_samples,
                         target_variables=target_variables)
        from ...components.distributions.random_gen import default_rand_gen
        self._rand_gen = rand_gen if rand_gen is not None \
            else default_rand_gen()
        self.jitter = jitter

    def compute(self, env, ctx):
        has_mean = self.model.F.factor.has_mean
        X = env[self.model.X]
        noise_var = env[self.model.noise_var]
        kern = self.model.kernel
        kern_params = kern.fetch_parameters(env)
        X, noise_var, kern_params = arrays_as_samples(
            [X, noise_var, kern_params])
        K = _noisy_K(kern, X, noise_var, kern_params, self.jitter)
        L = cholesky(K)
        Y_shape = realize_shape(self.model.Y.shape, env)
        out_shape = (self.num_samples,) + Y_shape
        L = broadcast_to_w_samples(L, out_shape[1:-1] + out_shape[-2:-1],
                                   self.num_samples)
        die = self._rand_gen.sample_normal(
            ctx.next_generator(), shape=out_shape,
            dtype=self.model.F.factor.dtype)
        y_samples = p_einsum("...ij,...jk->...ik", L, die)
        if has_mean:
            y_samples = y_samples + env[self.model.mean]
        samples = {self.model.Y.uuid: y_samples}
        if self.target_variables:
            return tuple(samples[v] for v in self.target_variables)
        return samples


class GPRegressionMeanVariancePrediction(SamplingAlgorithm):
    """Posterior predictive moments from the cached (X, L, LinvY)."""

    def __init__(self, model, posterior, observed, noise_free=True,
                 diagonal_variance=True):
        super().__init__(model=model, observed=observed,
                         extra_graphs=[posterior])
        self.noise_free = noise_free
        self.diagonal_variance = diagonal_variance

    @property
    def serving_data_axes(self):
        # (s, N, D) mean + (s, N) diag var | (s, N, N) covariance
        return ((1,), (1,)) if self.diagonal_variance \
            else ((1,), (1, 2))

    def _predictive_moments(self, env):
        has_mean = self.model.F.factor.has_mean
        X = env[self.model.X]
        N = X.shape[-2]
        noise_var = env[self.model.noise_var]
        posterior = self._extra_graphs[0]
        X_cond = env[posterior.X]
        L = env[posterior.L]
        LinvY = env[posterior.LinvY]
        kern = self.model.kernel
        kern_params = kern.fetch_parameters(env)
        X, noise_var, X_cond, L, LinvY, kern_params = arrays_as_samples(
            [X, noise_var, X_cond, L, LinvY, kern_params])
        Kxt = kern.K(X_cond, X, **kern_params)
        LinvKxt = _solve_lower(L, Kxt)
        mu = p_einsum("...mn,...md->...nd", LinvKxt, LinvY)
        if has_mean:
            mu = mu + env[self.model.mean]
        if self.diagonal_variance:
            Ktt = kern.Kdiag(X, **kern_params)
            var = Ktt - torch.sum(torch.square(LinvKxt), dim=-2)
            if not self.noise_free:
                var = var + noise_var
        else:
            Ktt = kern.K(X, **kern_params)
            var = Ktt - p_einsum("...mn,...mk->...nk", LinvKxt, LinvKxt)
            if not self.noise_free:
                var = var + torch.eye(N, dtype=X.dtype, device=X.device) * \
                    torch.unsqueeze(noise_var, -2)
        return mu, var, noise_var

    def compute(self, env, ctx):
        mu, var, _ = self._predictive_moments(env)
        outcomes = {self.model.Y.uuid: (mu, var)}
        if self.target_variables:
            return tuple(outcomes[v] for v in self.target_variables)
        return outcomes


class GPRegressionSamplingPrediction(GPRegressionMeanVariancePrediction):
    """Posterior predictive sampling: mean plus noise shaped by the
    diagonal variance, or by the factor of the full covariance."""

    serving_data_axes = ((1,),)  # one (s, N, D) samples leaf

    def __init__(self, model, posterior, observed, rand_gen=None,
                 noise_free=True, diagonal_variance=True, jitter=0.0):
        super().__init__(model=model, posterior=posterior, observed=observed,
                         noise_free=noise_free,
                         diagonal_variance=diagonal_variance)
        from ...components.distributions.random_gen import default_rand_gen
        self._rand_gen = rand_gen if rand_gen is not None \
            else default_rand_gen()
        self.jitter = jitter

    def compute(self, env, ctx):
        return _sample_predictive(
            self, env, ctx, lambda e: self._predictive_moments(e)[:2])


def _sample_predictive(alg, env, ctx, moments):
    """Posterior predictive draws for the exact and the collapsed GP's
    sampling predictions: ``moments(env)`` gives the mean and the diagonal
    variance or the full covariance, and the draw is the mean plus noise
    shaped by the variance's square root or by the covariance's factor."""
    if alg.diagonal_variance:
        mu, var = moments(env)
    else:
        # the full predictive covariance feeds a Cholesky below: pin
        # HIGHEST even when the data-side precision is relaxed
        with data_precision_scope("highest"):
            mu, var = moments(env)
    out_shape = (alg.num_samples,) + tuple(mu.shape[1:])
    die = alg._rand_gen.sample_normal(
        ctx.next_generator(), shape=out_shape,
        dtype=alg.model.F.factor.dtype)
    if alg.diagonal_variance:
        # clamp: tiny negative variances at training inputs (f32)
        var = torch.clamp(var, min=0.0)
        samples = mu + die * torch.sqrt(torch.unsqueeze(var, -1))
    else:
        cov = var
        if alg.jitter > 0.0:
            cov = cov + torch.eye(cov.shape[-1], dtype=cov.dtype,
                                  device=cov.device) * alg.jitter
        L = broadcast_to_w_samples(
            cholesky(cov), out_shape[1:-1] + out_shape[-2:-1],
            alg.num_samples)
        samples = mu + p_einsum("...ij,...jk->...ik", L, die)
    outcomes = {alg.model.Y.uuid: samples}
    if alg.target_variables:
        return tuple(outcomes[v] for v in alg.target_variables)
    return outcomes


class GPRegression(Module):
    """GP regression with a Gaussian likelihood."""

    #: one N x N Cholesky over every row
    row_separable = False

    def __init__(self, X, kernel, noise_var, mean=None, rand_gen=None,
                 dtype=None, jitter=0.0):
        # jitter stabilizes the PRIOR sampling path's Cholesky (the
        # marginal-likelihood/prediction algebra is regularized by the
        # noise variance and keeps jitter=0 by default)
        self.jitter = jitter
        if not isinstance(X, Variable):
            X = Variable(value=X)
        if not isinstance(noise_var, Variable):
            noise_var = Variable(value=noise_var)
        inputs = [("X", X), ("noise_var", noise_var)]
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

    def _generate_outputs(self, output_shapes):
        if output_shapes["random_variable"] is None:
            Y_shape = self.X.shape[:-1] + (1,)
        else:
            Y_shape = output_shapes["random_variable"]
        self.set_outputs([Variable(shape=Y_shape)])

    def _build_module_graphs(self):
        Y = self.random_variable
        graph = Model(name="gp_regression")
        graph.X = self.X.replicate_self()
        graph.noise_var = self.noise_var.replicate_self()
        mean = None
        if self._has_mean:
            graph.mean = self.mean.replicate_self()
            mean = graph.mean
        graph.F = GaussianProcess.define_variable(
            X=graph.X, kernel=self.kernel, shape=Y.shape, mean=mean,
            rand_gen=self._rand_gen, dtype=self.dtype, jitter=self.jitter)
        graph.Y = Y.replicate_self()
        graph.Y.set_prior(Normal(
            mean=graph.F,
            variance=broadcast_to(graph.noise_var, graph.Y.shape),
            rand_gen=self._rand_gen, dtype=self.dtype))
        graph.kernel = graph.F.factor.kernel
        # posterior graph = prediction-time cache of (X, L, LinvY)
        post = Posterior(graph)
        post.L = Variable(shape=graph.X.shape[:-1] + graph.X.shape[-2:-1])
        post.LinvY = Variable(shape=graph.X.shape[:-1] + graph.Y.shape[-1:])
        post.X = Variable(shape=graph.X.shape)
        self._cache_variables = [post.L, post.LinvY, post.X]
        return graph, [post]

    def _attach_default_inference_algorithms(self):
        observed = [v for _, v in self.inputs] + \
            [v for _, v in self.outputs]
        self.attach_log_pdf_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=GPRegressionLogPdf(self._module_graph,
                                         self._extra_graphs[0], observed),
            alg_name="gp_log_pdf")
        observed = [v for _, v in self.inputs]
        self.attach_draw_samples_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=GPRegressionSampling(self._module_graph, observed,
                                           rand_gen=self._rand_gen),
            alg_name="gp_sampling")
        self.attach_prediction_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=GPRegressionMeanVariancePrediction(
                self._module_graph, self._extra_graphs[0], observed),
            alg_name="gp_predict")

    @staticmethod
    def define_variable(X, kernel, noise_var, shape=None, mean=None,
                        rand_gen=None, dtype=None, jitter=0.0):
        gp = GPRegression(X=X, kernel=kernel, noise_var=noise_var, mean=mean,
                          rand_gen=rand_gen, dtype=dtype, jitter=jitter)
        gp._generate_outputs({"random_variable": shape})
        return gp.random_variable

    def replicate_self(self, attribute_map=None):
        rep = super().replicate_self(attribute_map)
        rep.kernel = self.kernel.replicate_self(attribute_map)
        if rep._module_graph is not None:
            # restore the non-component convenience attr lost by clone()
            rep._module_graph.kernel = \
                rep._module_graph.F.factor.kernel
        rep._has_mean = self._has_mean
        rep.jitter = self.jitter
        return rep
