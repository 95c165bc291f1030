"""Stochastic variational GP regression for count data (Poisson).

Counterpart of ``mxfusion_tpu/modules/gp_modules/svgp_poisson.py``: the
uncollapsed SVGP posterior with a Poisson likelihood. For the log link
(``rate = exp(f)``) the expected log-likelihood under ``q(f_n) =
N(mu_n, var_n)`` is closed form,

    E[log Poisson(y | e^f)] = y mu − exp(mu + var/2) − log Γ(y+1),

so the bound needs no quadrature. The ``softplus`` link uses the static
Gauss-Hermite grid of the classification module, and the classification
module's moment helpers (one copy of the cancellation-sensitive
algebra).
"""
import numpy as np
import torch

from ..module import Module
from ...models.model import Model
from ...models.posterior import Posterior
from ...components.variables.variable import Variable
from ...components.variables.var_trans import PositiveTransformation
from ...components.distributions.poisson import Poisson
from ...components.distributions.gp.gp import GaussianProcess
from ...components.distributions.gp.cond_gp import \
    ConditionalGaussianProcess
from ...components.functions.operators import exp as exp_op
from ...components.functions.operators import softplus as softplus_op
from ...inference.variational import VariationalInference
from ...inference.inference_alg import SamplingAlgorithm
from ...inference.forward_sampling import ForwardSamplingAlgorithm
from ...ops.elementwise import softplus
from .svgp_classification import (_q_f_moments, _neg_kl, _nodes,
                                  _labels_vs_moments, _VAR_FLOOR)


class SVGPPoissonLogPdf(VariationalInference):
    """ELBO  Σ_n E_{q(f_n)}[log Poisson(y_n | link(f_n))] − KL.

    ``link="log"``: closed form (no quadrature). ``link="softplus"``:
    fixed-order Gauss-Hermite over the rate nonlinearity."""

    def __init__(self, model, posterior, observed, jitter=0.0,
                 whitened=False, num_quadrature_points=20, link="log"):
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
        y = Y[..., 0]                                         # (s, N)
        var_safe = torch.clamp_min(var_f, _VAR_FLOOR)

        if self.link == "log":
            # E[y f] = y mu;  E[e^f] = exp(mu + var/2)  (lognormal mean)
            quad = (y * mu_f - torch.exp(mu_f + 0.5 * var_safe)
                    - torch.lgamma(y + 1.0))                  # (s, N)
        else:
            f, w = _nodes(mu_f, var_safe, self.num_quadrature_points)
            rate = softplus(f)
            # softplus(f) underflows to 0 for f << 0 (float32: f < -103),
            # and y·log(0) is NaN for a zero count; there log softplus(f)
            # is f to machine precision
            low = f < -30.0
            log_rate = torch.where(
                low, f, torch.log(torch.where(low, torch.ones_like(rate),
                                              rate)))
            log_lik = (y[..., None] * log_rate - rate
                       - torch.lgamma(y + 1.0)[..., None])
            quad = torch.sum(log_lik * w, dim=-1)
        logL = torch.sum(quad, dim=-1)
        return self.log_pdf_scaling * logL + _neg_kl(Linvmu, LinvLs, D)


class SVGPPoissonRatePrediction(SamplingAlgorithm):
    """Predictive count moments under q(f*).

    ``link="log"``: closed form, E[rate] = exp(mu + var/2), Var[rate] =
    E[rate]² (e^var − 1); ``link="softplus"``: quadrature. The count
    variance adds the Poisson noise by total variance: Var[y*] =
    E[rate] + Var[rate]. Returns {Y: (mean, variance)}."""

    serving_data_axes = ((1,), (1,))  # (s, N, 1) count moments

    def __init__(self, model, posterior, observed, jitter=0.0,
                 whitened=False, num_quadrature_points=20, link="log"):
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
        var_safe = torch.clamp_min(var_f, _VAR_FLOOR)
        if self.link == "log":
            rate_mean = torch.exp(mu_f + 0.5 * var_safe)
            rate_var = torch.square(rate_mean) * torch.expm1(var_safe)
        else:
            f, w = _nodes(mu_f, var_safe, self.num_quadrature_points)
            rate = softplus(f)
            rate_mean = torch.sum(rate * w, dim=-1)
            rate_var = torch.sum(torch.square(rate) * w, dim=-1) \
                - torch.square(rate_mean)
        mean = rate_mean[..., None]
        var = (rate_mean + rate_var)[..., None]   # total variance
        outcomes = {self.model.Y.uuid: (mean, var)}
        if self.target_variables:
            return tuple(outcomes[v] for v in self.target_variables)
        return outcomes


class SVGPPoissonRegression(Module):
    """SVGP count regression: ``log_pdf`` is the (closed-form for the
    log link) Poisson ELBO, ``predict`` the predictive count moments,
    sampling walks U → F → link(F) → Poisson."""

    #: the bound's data term is a sum over rows (the KL is global)
    row_separable = True

    def __init__(self, X, kernel, inducing_inputs=None, num_inducing=10,
                 mean=None, rand_gen=None, dtype=None, jitter=1e-5,
                 whitened=False, num_quadrature_points=20, link="log"):
        if link not in ("log", "softplus"):
            raise ValueError("link must be 'log' or 'softplus', got "
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
                "SVGPPoissonRegression models one count per row: the "
                "output event dim must be 1, got {}.".format(
                    Y_shape[-1]))
        self.set_outputs([Variable(shape=Y_shape)])

    def _build_module_graphs(self):
        Y = self.random_variable
        graph = Model(name="svgp_poisson")
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
        graph.rate = exp_op(graph.F) if self.link == "log" \
            else softplus_op(graph.F)
        graph.Y = Y.replicate_self()
        graph.Y.set_prior(Poisson(
            rate=graph.rate, rand_gen=self._rand_gen, dtype=self.dtype))
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
            algorithm=SVGPPoissonLogPdf(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened,
                num_quadrature_points=self.num_quadrature_points,
                link=self.link),
            alg_name="svgp_poisson_log_pdf")
        observed = [v for _, v in self.inputs]
        self.attach_draw_samples_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=ForwardSamplingAlgorithm(self._module_graph,
                                               observed),
            alg_name="svgp_poisson_sampling")
        self.attach_prediction_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=SVGPPoissonRatePrediction(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened,
                num_quadrature_points=self.num_quadrature_points,
                link=self.link),
            alg_name="svgp_poisson_predict")

    @staticmethod
    def define_variable(X, kernel, shape=None, inducing_inputs=None,
                        num_inducing=10, mean=None, rand_gen=None,
                        dtype=None, jitter=1e-5, whitened=False,
                        num_quadrature_points=20, link="log"):
        gp = SVGPPoissonRegression(
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
