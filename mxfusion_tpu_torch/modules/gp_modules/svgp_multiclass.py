"""Stochastic variational GP multi-class classification (softmax).

Counterpart of ``mxfusion_tpu/modules/gp_modules/svgp_multiclass.py``.
C latent GP columns share one kernel and one q(U) covariance. The
softmax expected log-likelihood has no quadrature form, so it is a
reparameterized Monte Carlo estimate from the diagonal q(f_n) marginals
(Hensman et al. 2015 §3), over a trailing (s, N, C, K) axis of normals
drawn by the module's ``rand_gen`` on the caller's generator. The
bound's linear algebra is the binary module's: one Kuu Cholesky, one
wide solve.
"""
import numpy as np
import torch

from ..module import Module
from ...models.model import Model
from ...models.posterior import Posterior
from ...components.variables.variable import Variable
from ...components.variables.var_trans import PositiveTransformation
from ...components.distributions.categorical import Categorical
from ...components.distributions.gp.gp import GaussianProcess
from ...components.distributions.gp.cond_gp import \
    ConditionalGaussianProcess
from ...components.distributions.random_gen import default_rand_gen
from ...inference.variational import VariationalInference
from ...inference.inference_alg import SamplingAlgorithm
from ...inference.forward_sampling import ForwardSamplingAlgorithm
from .svgp_classification import (_q_f_moments, _neg_kl,
                                  _labels_vs_moments, _VAR_FLOOR)


def _latent_draws(rand_gen, generator, mu_f, var_f, num_draws):
    """(s, N, C, K) draws of f from the diagonal marginals; var_f is
    column-shared, (s, N) broadcast over (C, K)."""
    s, N, C = mu_f.shape
    sd = torch.sqrt(torch.clamp_min(var_f, _VAR_FLOOR))[..., None, None]
    eps = rand_gen.sample_normal(generator, shape=(s, N, C, num_draws),
                                 dtype=mu_f.dtype)
    return mu_f[..., None] + sd * eps


class SVGPMultiClassLogPdf(VariationalInference):
    """MC ELBO: Σ_n E_{q(f_n)}[f_{n,y_n} − logsumexp_c f_{n,c}] − KL.

    Labels are one-hot (N, C) floats."""

    def __init__(self, model, posterior, observed, jitter=0.0,
                 whitened=False, num_mc_samples=8, rand_gen=None):
        super().__init__(num_samples=1, model=model, posterior=posterior,
                         observed=observed)
        self.log_pdf_scaling = 1.0
        self.jitter = jitter
        self.whitened = whitened
        self.num_mc_samples = num_mc_samples
        self._rand_gen = rand_gen if rand_gen is not None \
            else default_rand_gen()

    def compute(self, env, ctx):
        mu_f, var_f, Linvmu, LinvLs = _q_f_moments(
            env, self.model, self.posterior, self.jitter, self.whitened,
            keep_columns=True)
        C = mu_f.shape[-1]
        Y = _labels_vs_moments(env[self.model.Y], mu_f.shape[0])
        f = _latent_draws(self._rand_gen, ctx.next_generator(), mu_f,
                          var_f, self.num_mc_samples)     # (s, N, C, K)
        ce = torch.sum(Y[..., None] * f, dim=-2) - \
            torch.logsumexp(f, dim=-2)                    # (s, N, K)
        logL = torch.sum(torch.mean(ce, dim=-1), dim=-1)  # (s,)
        return self.log_pdf_scaling * logL + _neg_kl(Linvmu, LinvLs, C)


class SVGPMultiClassProbPrediction(SamplingAlgorithm):
    """Predictive class probabilities: the MC mean of softmax(f*).
    Returns {Y: (p, p(1−p))} with p of shape (s, N, C)."""

    serving_data_axes = ((1,), (1,))  # (s, N, C): outputs trail

    def __init__(self, model, posterior, observed, jitter=0.0,
                 whitened=False, num_mc_samples=64, rand_gen=None):
        super().__init__(model=model, observed=observed,
                         extra_graphs=[posterior])
        self.jitter = jitter
        self.whitened = whitened
        self.num_mc_samples = num_mc_samples
        self._rand_gen = rand_gen if rand_gen is not None \
            else default_rand_gen()

    def compute(self, env, ctx):
        posterior = self._extra_graphs[0]
        mu_f, var_f, _, _ = _q_f_moments(
            env, self.model, posterior, self.jitter, self.whitened,
            keep_columns=True)
        f = _latent_draws(self._rand_gen, ctx.next_generator(), mu_f,
                          var_f, self.num_mc_samples)
        p = torch.mean(torch.softmax(f, dim=-2), dim=-1)  # (s, N, C)
        outcomes = {self.model.Y.uuid: (p, p * (1.0 - p))}
        if self.target_variables:
            return tuple(outcomes[v] for v in self.target_variables)
        return outcomes


class SVGPMultiClassification(Module):
    """Multi-class SVGP classification: one-hot (N, C) outputs, softmax
    link, MC expected log-likelihood, shared-kernel latent columns."""

    #: the bound's data term is a sum over rows (the KL is global)
    row_separable = True

    def __init__(self, X, kernel, num_classes, inducing_inputs=None,
                 num_inducing=10, rand_gen=None, dtype=None, jitter=1e-5,
                 whitened=False, num_mc_samples=8,
                 num_predict_mc_samples=None):
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2.")
        self.num_classes = int(num_classes)
        self.jitter = jitter
        self.whitened = whitened
        self.num_mc_samples = num_mc_samples
        # prediction is a one-shot pass, so it defaults to a higher
        # fidelity than the per-step training estimator
        self.num_predict_mc_samples = (
            max(64, num_mc_samples) if num_predict_mc_samples is None
            else num_predict_mc_samples)
        if not isinstance(X, Variable):
            X = Variable(value=X)
        if inducing_inputs is None:
            inducing_inputs = Variable(
                shape=(num_inducing, kernel.input_dim),
                initial_value=np.random.randn(num_inducing,
                                              kernel.input_dim))
        inputs = [("X", X), ("inducing_inputs", inducing_inputs)]
        super().__init__(inputs=inputs, outputs=None,
                         input_names=[k for k, _ in inputs],
                         output_names=["random_variable"],
                         rand_gen=rand_gen, dtype=dtype)
        self.kernel = kernel

    def _generate_outputs(self, output_shapes=None):
        if output_shapes["random_variable"] is None:
            Y_shape = self.X.shape[:-1] + (self.num_classes,)
        else:
            Y_shape = output_shapes["random_variable"]
        if Y_shape[-1] != self.num_classes:
            raise ValueError(
                "output event dim {} != num_classes {} (labels are "
                "one-hot).".format(Y_shape[-1], self.num_classes))
        self.set_outputs([Variable(shape=Y_shape)])

    def _build_module_graphs(self):
        Y = self.random_variable
        C = self.num_classes
        graph = Model(name="svgp_multiclass")
        graph.X = self.X.replicate_self()
        graph.inducing_inputs = self.inducing_inputs.replicate_self()
        M = self.inducing_inputs.shape[0]
        graph.U = GaussianProcess.define_variable(
            X=graph.inducing_inputs, kernel=self.kernel,
            shape=(graph.inducing_inputs.shape[0], C),
            rand_gen=self._rand_gen, dtype=self.dtype, jitter=self.jitter)
        graph.F = ConditionalGaussianProcess.define_variable(
            X=graph.X, X_cond=graph.inducing_inputs, Y_cond=graph.U,
            kernel=self.kernel, shape=Y.shape,
            rand_gen=self._rand_gen, dtype=self.dtype, jitter=self.jitter)
        graph.Y = Y.replicate_self()
        # logits straight into a normalized one-hot Categorical
        graph.Y.set_prior(Categorical(
            log_prob=graph.F, num_classes=C, one_hot_encoding=True,
            normalization=True, rand_gen=self._rand_gen,
            dtype=self.dtype))
        graph.kernel = graph.U.factor.kernel
        post = Posterior(graph)
        post.qU_cov_diag = Variable(
            shape=(M,), transformation=PositiveTransformation(),
            initial_value=np.ones(M) * 1e-6)
        post.qU_cov_W = Variable(shape=(M, M), initial_value=np.eye(M))
        post.qU_mean = Variable(shape=(M, C))
        return graph, [post]

    def _attach_default_inference_algorithms(self):
        observed = [v for _, v in self.inputs] + \
            [v for _, v in self.outputs]
        self.attach_log_pdf_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=SVGPMultiClassLogPdf(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened,
                num_mc_samples=self.num_mc_samples,
                rand_gen=self._rand_gen),
            alg_name="svgp_mc_log_pdf")
        observed = [v for _, v in self.inputs]
        self.attach_draw_samples_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=ForwardSamplingAlgorithm(self._module_graph,
                                               observed),
            alg_name="svgp_mc_sampling")
        self.attach_prediction_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=SVGPMultiClassProbPrediction(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened,
                num_mc_samples=self.num_predict_mc_samples,
                rand_gen=self._rand_gen),
            alg_name="svgp_mc_predict")

    @staticmethod
    def define_variable(X, kernel, num_classes, shape=None,
                        inducing_inputs=None, num_inducing=10,
                        rand_gen=None, dtype=None, jitter=1e-5,
                        whitened=False, num_mc_samples=8,
                        num_predict_mc_samples=None):
        gp = SVGPMultiClassification(
            X=X, kernel=kernel, num_classes=num_classes,
            inducing_inputs=inducing_inputs, num_inducing=num_inducing,
            rand_gen=rand_gen, dtype=dtype, jitter=jitter,
            whitened=whitened, num_mc_samples=num_mc_samples,
            num_predict_mc_samples=num_predict_mc_samples)
        gp._generate_outputs({"random_variable": shape})
        return gp.random_variable

    def replicate_self(self, attribute_map=None):
        rep = super().replicate_self(attribute_map)
        rep.kernel = self.kernel.replicate_self(attribute_map)
        if rep._module_graph is not None:
            rep._module_graph.kernel = rep._module_graph.U.factor.kernel
        rep.num_classes = self.num_classes
        rep.jitter = self.jitter
        rep.whitened = self.whitened
        rep.num_mc_samples = self.num_mc_samples
        rep.num_predict_mc_samples = self.num_predict_mc_samples
        return rep
