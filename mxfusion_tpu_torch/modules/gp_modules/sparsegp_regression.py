"""Titsias-style collapsed sparse GP regression (variational DTC).

Counterpart of ``mxfusion_tpu/modules/gp_modules/sparsegp_regression.py``.
The internal model adds inducing inputs Z with ``U ~ GP(Z)`` and
``F ~ CondGP(X | Z, U)``. The collapsed lower bound needs one M × M
Cholesky of Kuu and one of A = I + L⁻¹Kuf·(L⁻¹Kuf)ᵀ/σ², and caches
``(L, LA, wv)`` for prediction. On the card an RBF kernel builds Kuu and
Kuf (twice per training step) and Kxt (once per prediction chunk) with
K1; the bound runs at the HIGHEST tier as a whole.
"""
import math

import numpy as np
import torch

from ..module import Module
from ...models.model import Model
from ...models.posterior import Posterior
from ...components.variables.variable import Variable
from ...components.variables.runtime_variable import arrays_as_samples
from ...components.distributions.normal import Normal
from ...components.distributions.gp.gp import GaussianProcess
from ...components.distributions.gp.cond_gp import \
    ConditionalGaussianProcess
from ...components.functions.operators import broadcast_to
from ...inference.variational import VariationalInference
from ...inference.inference_alg import SamplingAlgorithm
from ...inference.forward_sampling import ForwardSamplingAlgorithm
from ...ops.linalg import cholesky, wide_triangular_solve
from ...ops.precision import einsum as p_einsum
from ...ops.precision import data_precision_scope
from .gp_regression import _sample_predictive
from .svgp_regression import _solve_lower, _solve_lower_t

LOG2PI = math.log(2.0 * math.pi)


class SparseGPRegressionLogPdf(VariationalInference):
    """Collapsed variational bound."""

    def __init__(self, model, posterior, observed, jitter=0.0):
        super().__init__(num_samples=1, model=model, posterior=posterior,
                         observed=observed)
        self.log_pdf_scaling = 1.0
        self.jitter = jitter

    def compute(self, env, ctx):
        # A = I + LinvKuf·LinvKufᵀ/σ² feeds a Cholesky, so the relaxable
        # data-side precision is pinned to HIGHEST for the whole bound.
        # Each product's backward keeps the tier it ran its forward at,
        # so the pin holds in the gradient too, after this block closes.
        with data_precision_scope("highest"):
            return self._compute_highest(env, ctx)

    def _compute_highest(self, env, ctx):
        has_mean = self.model.F.factor.has_mean
        X = env[self.model.X]
        Y = env[self.model.Y]
        Z = env[self.model.inducing_inputs]
        noise_var = env[self.model.noise_var]
        D = Y.shape[-1]
        M = Z.shape[-2]
        kern = self.model.kernel
        kern_params = kern.fetch_parameters(env)
        X, Y, Z, noise_var, kern_params = arrays_as_samples(
            [X, Y, Z, noise_var, kern_params])

        noise_var_m = torch.unsqueeze(noise_var, -2)  # (s, 1, 1)
        eye_m = torch.eye(M, dtype=Z.dtype, device=Z.device)

        Kuu = kern.K(Z, **kern_params)
        if self.jitter > 0.0:
            Kuu = Kuu + eye_m * self.jitter
        Kuf = kern.K(Z, X, **kern_params)
        Kff_diag = kern.Kdiag(X, **kern_params)

        L = cholesky(Kuu)
        LinvKuf = wide_triangular_solve(L, Kuf, lower=True)

        A = eye_m + p_einsum("...mn,...kn->...mk",
                             LinvKuf, LinvKuf) / noise_var_m
        LA = cholesky(A)

        if has_mean:
            Y = Y - env[self.model.mean]
        LAInvLinvKufY = _solve_lower(
            LA, p_einsum("...mn,...nd->...md", LinvKuf, Y))

        # log diag LA, without abs, as written in JAX
        sumlogdiag_LA = torch.sum(torch.log(
            torch.diagonal(LA, dim1=-2, dim2=-1)), dim=-1)
        logL = -D * sumlogdiag_LA
        logL = logL - torch.sum(
            torch.square(Y) / noise_var_m + LOG2PI + torch.log(noise_var_m),
            dim=(-2, -1)) / 2.0
        logL = logL + torch.sum(
            torch.square(LAInvLinvKufY) / (2.0 * torch.square(noise_var_m)),
            dim=(-2, -1))
        logL = logL - D * torch.sum(Kff_diag / (2.0 * noise_var), dim=-1)
        logL = logL + D * torch.sum(
            torch.square(LinvKuf) / (2.0 * noise_var_m), dim=(-2, -1))
        logL = logL * self.log_pdf_scaling

        wv = _solve_lower_t(L, _solve_lower_t(LA, LAInvLinvKufY)) / \
            noise_var_m
        # the prediction cache: sample 0, as in JAX
        posterior = self._extra_graphs[0]
        self.set_parameter(ctx, posterior.wv, wv[0])
        self.set_parameter(ctx, posterior.L, L[0])
        self.set_parameter(ctx, posterior.LA, LA[0])
        return logL


class SparseGPRegressionMeanVariancePrediction(SamplingAlgorithm):
    """Predictive moments from the cached (L, LA, wv)."""

    def __init__(self, model, posterior, observed, target_variables=None,
                 noise_free=True, diagonal_variance=True):
        super().__init__(model=model, observed=observed,
                         target_variables=target_variables,
                         extra_graphs=[posterior])
        self.noise_free = noise_free
        self.diagonal_variance = diagonal_variance

    @property
    def serving_data_axes(self):
        # (s, N, D) mean + (s, N) diag var | (s, N, N) covariance
        return ((1,), (1,)) if self.diagonal_variance \
            else ((1,), (1, 2))

    def _moments(self, env):
        has_mean = self.model.F.factor.has_mean
        X = env[self.model.X]
        N = X.shape[-2]
        Z = env[self.model.inducing_inputs]
        noise_var = env[self.model.noise_var]
        posterior = self._extra_graphs[0]
        L = env[posterior.L]
        LA = env[posterior.LA]
        wv = env[posterior.wv]
        kern = self.model.kernel
        kern_params = kern.fetch_parameters(env)
        X, Z, noise_var, L, LA, wv, kern_params = arrays_as_samples(
            [X, Z, noise_var, L, LA, wv, kern_params])

        Kxt = kern.K(Z, X, **kern_params)
        mu = p_einsum("...mn,...md->...nd", Kxt, wv)
        if has_mean:
            mu = mu + env[self.model.mean]
        LinvKxt = _solve_lower(L, Kxt)
        LAinvLinvKxt = _solve_lower(LA, LinvKxt)
        if self.diagonal_variance:
            Ktt = kern.Kdiag(X, **kern_params)
            var = Ktt - torch.sum(torch.square(LinvKxt), dim=-2) + \
                torch.sum(torch.square(LAinvLinvKxt), dim=-2)
            if not self.noise_free:
                var = var + noise_var
        else:
            Ktt = kern.K(X, **kern_params)
            var = Ktt - \
                p_einsum("...mn,...mk->...nk", LinvKxt, LinvKxt) + \
                p_einsum("...mn,...mk->...nk", LAinvLinvKxt, LAinvLinvKxt)
            if not self.noise_free:
                var = var + torch.eye(N, dtype=X.dtype, device=X.device) * \
                    torch.unsqueeze(noise_var, -2)
        return mu, var

    def compute(self, env, ctx):
        mu, var = self._moments(env)
        outcomes = {self.model.Y.uuid: (mu, var)}
        if self.target_variables:
            return tuple(outcomes[v] for v in self.target_variables)
        return outcomes


class SparseGPRegressionSamplingPrediction(
        SparseGPRegressionMeanVariancePrediction):
    """Predictive sampling from the cached (L, LA, wv)."""

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
        return _sample_predictive(self, env, ctx, self._moments)


class SparseGPRegression(Module):
    """Sparse (collapsed) GP regression module."""

    #: the collapsed bound's A = I + GG^T/s2 couples the rows
    row_separable = False

    def __init__(self, X, kernel, noise_var, inducing_inputs=None,
                 num_inducing=10, mean=None, rand_gen=None, dtype=None,
                 jitter=1e-5):
        self.jitter = jitter
        if not isinstance(X, Variable):
            X = Variable(value=X)
        if not isinstance(noise_var, Variable):
            noise_var = Variable(value=noise_var)
        if inducing_inputs is None:
            inducing_inputs = Variable(
                shape=(num_inducing, kernel.input_dim),
                initial_value=np.random.randn(num_inducing,
                                              kernel.input_dim))
        inputs = [("X", X), ("inducing_inputs", inducing_inputs),
                  ("noise_var", noise_var)]
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
        self.set_outputs([Variable(shape=Y_shape)])

    def _build_module_graphs(self):
        Y = self.random_variable
        graph = Model(name="sparsegp_regression")
        graph.X = self.X.replicate_self()
        graph.inducing_inputs = self.inducing_inputs.replicate_self()
        M = self.inducing_inputs.shape[0]
        graph.noise_var = self.noise_var.replicate_self()
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
        graph.Y = Y.replicate_self()
        graph.Y.set_prior(Normal(
            mean=graph.F,
            variance=broadcast_to(graph.noise_var, graph.Y.shape),
            rand_gen=self._rand_gen, dtype=self.dtype))
        graph.kernel = graph.U.factor.kernel
        post = Posterior(graph)
        post.L = Variable(shape=(M, M))
        post.LA = Variable(shape=(M, M))
        post.wv = Variable(shape=(M, Y.shape[-1]))
        self._cache_variables = [post.L, post.LA, post.wv]
        return graph, [post]

    def _attach_default_inference_algorithms(self):
        observed = [v for _, v in self.inputs] + \
            [v for _, v in self.outputs]
        self.attach_log_pdf_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=SparseGPRegressionLogPdf(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter),
            alg_name="sgp_log_pdf")
        observed = [v for _, v in self.inputs]
        self.attach_draw_samples_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=ForwardSamplingAlgorithm(self._module_graph, observed),
            alg_name="sgp_sampling")
        self.attach_prediction_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=SparseGPRegressionMeanVariancePrediction(
                self._module_graph, self._extra_graphs[0], observed),
            alg_name="sgp_predict")

    @staticmethod
    def define_variable(X, kernel, noise_var, shape=None,
                        inducing_inputs=None, num_inducing=10, mean=None,
                        rand_gen=None, dtype=None, jitter=1e-5):
        gp = SparseGPRegression(
            X=X, kernel=kernel, noise_var=noise_var,
            inducing_inputs=inducing_inputs, num_inducing=num_inducing,
            mean=mean, rand_gen=rand_gen, dtype=dtype, jitter=jitter)
        gp._generate_outputs({"random_variable": shape})
        return gp.random_variable

    def replicate_self(self, attribute_map=None):
        rep = super().replicate_self(attribute_map)
        rep.kernel = self.kernel.replicate_self(attribute_map)
        if rep._module_graph is not None:
            # restore the non-component convenience attr lost by clone()
            rep._module_graph.kernel = \
                rep._module_graph.U.factor.kernel
        rep._has_mean = self._has_mean
        rep.jitter = self.jitter
        return rep
