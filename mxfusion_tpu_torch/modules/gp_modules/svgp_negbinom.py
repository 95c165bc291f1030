"""Stochastic variational GP regression for overdispersed counts
(negative binomial).

Counterpart of ``mxfusion_tpu/modules/gp_modules/svgp_negbinom.py``.
The NB likelihood adds a trainable dispersion ``alpha`` (Var[y] = mu +
alpha mu², a positive module input fitted by the same optimizer step as
the kernel). Log link only: the expected log-likelihood has no closed
form (log(r + e^f)), so it uses the shared Gauss-Hermite grid, and
``nb_log_pmf`` with f as the log mean.
"""
import numpy as np
import torch

from ..module import Module
from ...models.model import Model
from ...models.posterior import Posterior
from ...components.variables.variable import Variable
from ...components.variables.var_trans import PositiveTransformation
from ...components.variables.runtime_variable import arrays_as_samples
from ...components.distributions.negative_binomial import (
    NegativeBinomial, nb_log_pmf)
from ...components.distributions.gp.gp import GaussianProcess
from ...components.distributions.gp.cond_gp import \
    ConditionalGaussianProcess
from ...components.functions.operators import exp as exp_op
from ...components.functions.operators import broadcast_to
from ...inference.variational import VariationalInference
from ...inference.inference_alg import SamplingAlgorithm
from ...inference.forward_sampling import ForwardSamplingAlgorithm
from .svgp_classification import (_q_f_moments, _neg_kl, _nodes,
                                  _labels_vs_moments, _VAR_FLOOR)


def _dispersion_vs_points(alpha):
    """Shape a sampled dispersion for broadcasting against (s, N[, Q])
    moments: scalar (s, 1) -> (s, 1, 1); per point (s, N) or (s, N, 1)
    -> (s, N, 1)."""
    if alpha.ndim == 3:
        if alpha.shape[-1] != 1:
            raise ValueError(
                "dispersion must be scalar or one value per data row; "
                "got event shape {}.".format(tuple(alpha.shape[1:])))
        return alpha
    return alpha[..., None]


class SVGPNegBinomialLogPdf(VariationalInference):
    """ELBO  Σ_n E_{q(f_n)}[log NB(y_n | e^{f_n}, alpha)] − KL, by
    Gauss-Hermite quadrature."""

    def __init__(self, model, posterior, observed, jitter=0.0,
                 whitened=False, num_quadrature_points=20):
        super().__init__(num_samples=1, model=model, posterior=posterior,
                         observed=observed)
        self.log_pdf_scaling = 1.0
        self.jitter = jitter
        self.whitened = whitened
        self.num_quadrature_points = num_quadrature_points

    def compute(self, env, ctx):
        alpha = env[self.model.dispersion]
        mu_f, var_f, Linvmu, LinvLs = _q_f_moments(
            env, self.model, self.posterior, self.jitter, self.whitened)
        Y = _labels_vs_moments(env[self.model.Y], mu_f.shape[0])
        (alpha,) = arrays_as_samples([alpha])
        alpha = _dispersion_vs_points(alpha)          # (s,1,1)|(s,N,1)
        D = Linvmu.shape[-1]
        y = Y[..., 0]                                 # (s, N)
        var_safe = torch.clamp_min(var_f, _VAR_FLOOR)

        f, w = _nodes(mu_f, var_safe, self.num_quadrature_points)
        log_lik = nb_log_pmf(y[..., None], f, alpha)
        quad = torch.sum(log_lik * w, dim=-1)
        logL = torch.sum(quad, dim=-1)
        return self.log_pdf_scaling * logL + _neg_kl(Linvmu, LinvLs, D)


class SVGPNegBinomialPrediction(SamplingAlgorithm):
    """Predictive count moments: E[y*] = E[rate] (closed form under the
    log link), Var[y*] by total variance with the NB noise: Var[y] =
    E[rate] + alpha E[rate²] + Var[rate]."""

    serving_data_axes = ((1,), (1,))  # (s, N, 1) count moments

    def __init__(self, model, posterior, observed, jitter=0.0,
                 whitened=False):
        super().__init__(model=model, observed=observed,
                         extra_graphs=[posterior])
        self.jitter = jitter
        self.whitened = whitened

    def compute(self, env, ctx):
        posterior = self._extra_graphs[0]
        alpha = env[self.model.dispersion]
        mu_f, var_f, _, _ = _q_f_moments(
            env, self.model, posterior, self.jitter, self.whitened)
        (alpha,) = arrays_as_samples([alpha])
        alpha = _dispersion_vs_points(alpha)[..., 0]  # (s,1)|(s,N)
        var_safe = torch.clamp_min(var_f, _VAR_FLOOR)
        rate_mean = torch.exp(mu_f + 0.5 * var_safe)
        # stable forms: E[rate²] = rate_mean² e^v, Var[rate] =
        # rate_mean² expm1(v) (the naive difference cancels as v -> 0)
        rm2 = torch.square(rate_mean)
        rate_sq = rm2 * torch.exp(var_safe)
        rate_var = rm2 * torch.expm1(var_safe)
        mean = rate_mean[..., None]
        var = (rate_mean + alpha * rate_sq + rate_var)[..., None]
        outcomes = {self.model.Y.uuid: (mean, var)}
        if self.target_variables:
            return tuple(outcomes[v] for v in self.target_variables)
        return outcomes


class SVGPNegBinomialRegression(Module):
    """SVGP overdispersed-count regression with a trainable dispersion."""

    #: the bound's data term is a sum over rows (the KL is global)
    row_separable = True

    def __init__(self, X, kernel, dispersion=None, inducing_inputs=None,
                 num_inducing=10, mean=None, rand_gen=None, dtype=None,
                 jitter=1e-5, whitened=False, num_quadrature_points=20):
        self.jitter = jitter
        self.whitened = whitened
        self.num_quadrature_points = num_quadrature_points
        if not isinstance(X, Variable):
            X = Variable(value=X)
        if dispersion is None:
            dispersion = Variable(
                transformation=PositiveTransformation(),
                initial_value=0.5)
        elif not isinstance(dispersion, Variable):
            dispersion = Variable(value=dispersion)
        if inducing_inputs is None:
            inducing_inputs = Variable(
                shape=(num_inducing, kernel.input_dim),
                initial_value=np.random.randn(num_inducing,
                                              kernel.input_dim))
        inputs = [("X", X), ("inducing_inputs", inducing_inputs),
                  ("dispersion", dispersion)]
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
                "SVGPNegBinomialRegression models one count per row: "
                "the output event dim must be 1, got {}.".format(
                    Y_shape[-1]))
        self.set_outputs([Variable(shape=Y_shape)])

    def _build_module_graphs(self):
        Y = self.random_variable
        graph = Model(name="svgp_negbinom")
        graph.X = self.X.replicate_self()
        graph.inducing_inputs = self.inducing_inputs.replicate_self()
        graph.dispersion = self.dispersion.replicate_self()
        M = self.inducing_inputs.shape[0]
        graph.U = GaussianProcess.define_variable(
            X=graph.inducing_inputs, kernel=self.kernel,
            shape=(graph.inducing_inputs.shape[0], Y.shape[-1]),
            rand_gen=self._rand_gen, dtype=self.dtype,
            jitter=self.jitter)
        mean = None
        if self._has_mean:
            graph.mean = self.mean.replicate_self()
            mean = graph.mean
        graph.F = ConditionalGaussianProcess.define_variable(
            X=graph.X, X_cond=graph.inducing_inputs, Y_cond=graph.U,
            kernel=self.kernel, shape=Y.shape, mean=mean,
            rand_gen=self._rand_gen, dtype=self.dtype,
            jitter=self.jitter)
        graph.rate = exp_op(graph.F)
        graph.Y = Y.replicate_self()
        graph.Y.set_prior(NegativeBinomial(
            mean=graph.rate,
            dispersion=broadcast_to(graph.dispersion, graph.Y.shape),
            rand_gen=self._rand_gen, dtype=self.dtype))
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
            algorithm=SVGPNegBinomialLogPdf(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened,
                num_quadrature_points=self.num_quadrature_points),
            alg_name="svgp_nb_log_pdf")
        observed = [v for _, v in self.inputs]
        self.attach_draw_samples_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=ForwardSamplingAlgorithm(self._module_graph,
                                               observed),
            alg_name="svgp_nb_sampling")
        self.attach_prediction_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=SVGPNegBinomialPrediction(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened),
            alg_name="svgp_nb_predict")

    @staticmethod
    def define_variable(X, kernel, shape=None, dispersion=None,
                        inducing_inputs=None, num_inducing=10, mean=None,
                        rand_gen=None, dtype=None, jitter=1e-5,
                        whitened=False, num_quadrature_points=20):
        gp = SVGPNegBinomialRegression(
            X=X, kernel=kernel, dispersion=dispersion,
            inducing_inputs=inducing_inputs, num_inducing=num_inducing,
            mean=mean, rand_gen=rand_gen, dtype=dtype, jitter=jitter,
            whitened=whitened,
            num_quadrature_points=num_quadrature_points)
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
        return rep
