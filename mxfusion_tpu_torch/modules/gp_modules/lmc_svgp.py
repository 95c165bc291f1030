"""Correlated multi-output SVGP regression (Linear Model of
Coregionalization).

Counterpart of ``mxfusion_tpu/modules/gp_modules/lmc_svgp.py``. C
observed outputs are linear mixtures of Q latent independent SVGP
columns, y_n = Wᵀ g(x_n) + ε (Alvarez, Rosasco & Lawrence 2012, §4; the
semiparametric latent factor model of Teh, Seeger & Jordan 2005). The
latent columns share one kernel and one q(U) covariance, so the bound's
linear algebra is one Kuu Cholesky and one wide solve whatever C is, and
the mixing is one (N, Q) × (Q, C) product.

With a Gaussian likelihood the expected log-likelihood is closed form:
q((Wᵀg)_nc) has mean (mu_g,n W)_c and variance var_g,n·‖W_:c‖² (the
latent variance is column-shared), so

  E_q[log N(y_nc | ., σ_c²)] = −½[log 2πσ_c²
      + ((y_nc − (mu W)_c)² + var_n ‖W_:c‖²) / σ_c²].

No quadrature and no draws: the bound is deterministic. On the card,
Kuu and Kuf (RBF, float32) are K1 launches through ``RBF.K``.
"""
import math

import numpy as np
import torch

from ..module import Module
from ...models.model import Model
from ...models.posterior import Posterior
from ...components.variables.variable import Variable
from ...components.variables.var_trans import PositiveTransformation
from ...components.variables.runtime_variable import arrays_as_samples
from ...components.distributions.normal import Normal
from ...components.distributions.gp.gp import GaussianProcess
from ...components.distributions.gp.cond_gp import \
    ConditionalGaussianProcess
from ...components.functions.operators import broadcast_to, dot
from ...inference.variational import VariationalInference
from ...inference.inference_alg import SamplingAlgorithm
from ...inference.forward_sampling import ForwardSamplingAlgorithm
from ...ops.precision import einsum as p_einsum
from ...ops.linalg import make_diagonal
from .svgp_classification import _q_f_moments, _neg_kl


def _mixed_moments(env, model, posterior, jitter, whitened):
    """Diagonal q-moments of the mixed process at the model's X: (mean
    (s, N, C), variance (s, N, C), Linvmu, LinvLs, W (s, Q, C), noise
    (s, ·, ·))."""
    mu_g, var_g, Linvmu, LinvLs = _q_f_moments(
        env, model, posterior, jitter, whitened, keep_columns=True)
    (W, noise_var) = arrays_as_samples(
        [env[model.mixing_matrix], env[model.noise_var]])
    mean = p_einsum("...nq,...qc->...nc", mu_g, W)
    w2 = torch.sum(torch.square(W), dim=-2)           # (s, C)
    var = var_g[..., None] * w2[..., None, :]         # (s, N, C)
    return mean, var, Linvmu, LinvLs, W, noise_var


def _noise_per_output(noise_var):
    """The noise variance as (s, 1, 1) (scalar) or (s, 1, C)
    (per-output)."""
    return noise_var if noise_var.ndim == 3 else noise_var[..., None, :]


class LMCSVGPLogPdf(VariationalInference):
    """Closed-form LMC ELBO: Σ_nc E_q[log N(y_nc | (Wᵀg)_c, σ²)] − KL.

    The KL term is over the Q latent columns (one shared q(U)
    covariance), the same block as the other uncollapsed SVGP bounds."""

    def __init__(self, model, posterior, observed, jitter=0.0,
                 whitened=False):
        super().__init__(num_samples=1, model=model, posterior=posterior,
                         observed=observed)
        self.log_pdf_scaling = 1.0
        self.jitter = jitter
        self.whitened = whitened

    def compute(self, env, ctx):
        Y = env[self.model.Y]
        mean, var, Linvmu, LinvLs, W, noise_var = _mixed_moments(
            env, self.model, self.posterior, self.jitter, self.whitened)
        s = mean.shape[0]
        if Y.shape[0] != s:
            (Y,) = arrays_as_samples([Y])
            Y = Y.expand((s,) + tuple(Y.shape[1:]))
        Q = Linvmu.shape[-1]
        nv = _noise_per_output(noise_var)
        quad = (torch.square(Y - mean) + var) / nv
        ll = -0.5 * (torch.log(2.0 * math.pi * nv) + quad)
        logL = torch.sum(ll, dim=(-2, -1))
        return self.log_pdf_scaling * logL + _neg_kl(Linvmu, LinvLs, Q)


class LMCSVGPMeanVariancePrediction(SamplingAlgorithm):
    """Predictive per-output moments {Y: (mean, var)} with mean
    (s, N, C); ``var`` is (s, N, C) (diagonal over outputs, the default)
    or, with ``full_output_cov=True``, the (s, N, C, C) per-point
    cross-output covariance var_n·WᵀW, still diagonal over N."""

    def __init__(self, model, posterior, observed, noise_free=True,
                 full_output_cov=False, jitter=0.0, whitened=False):
        super().__init__(model=model, observed=observed,
                         extra_graphs=[posterior])
        self.noise_free = noise_free
        self.full_output_cov = full_output_cov
        self.jitter = jitter
        self.whitened = whitened

    # mean (s, N, C) and var (s, N, C) or cov (s, N, C, C): the only data
    # axis is axis 1 (the trailing axes are outputs)
    serving_data_axes = ((1,), (1,))

    def compute(self, env, ctx):
        posterior = self._extra_graphs[0]
        mu_g, var_g, _, _ = _q_f_moments(
            env, self.model, posterior, self.jitter, self.whitened,
            keep_columns=True)
        (W, noise_var) = arrays_as_samples(
            [env[self.model.mixing_matrix], env[self.model.noise_var]])
        mean = p_einsum("...nq,...qc->...nc", mu_g, W)
        nv = _noise_per_output(noise_var)
        if self.full_output_cov:
            WtW = p_einsum("...qc,...qd->...cd", W, W)        # (s, C, C)
            cov = var_g[..., None, None] * WtW[..., None, :, :]
            if not self.noise_free:
                cov = cov + make_diagonal(torch.broadcast_to(nv, mean.shape))
            out = (mean, cov)
        else:
            w2 = torch.sum(torch.square(W), dim=-2)            # (s, C)
            var = var_g[..., None] * w2[..., None, :]
            if not self.noise_free:
                var = var + nv
            out = (mean, var)
        outcomes = {self.model.Y.uuid: out}
        if self.target_variables:
            return tuple(outcomes[v] for v in self.target_variables)
        return outcomes


class LMCSVGPRegression(Module):
    """Multi-output SVGP regression with a trainable (Q, C) mixing
    matrix over Q shared-kernel latent columns. ``mixing_matrix`` and
    ``noise_var`` are module inputs, so they may be plain parameters or
    carry priors like any other variable. ``noise_var`` is scalar
    (shared) or of shape (C,) (per-output)."""

    #: the bound's data term is a sum over rows (the KL is global)
    row_separable = True

    def __init__(self, X, kernel, num_outputs, num_latents=None,
                 noise_var=None, mixing_matrix=None, inducing_inputs=None,
                 num_inducing=10, rand_gen=None, dtype=None, jitter=1e-5,
                 whitened=False):
        if num_outputs < 1:
            raise ValueError("num_outputs must be >= 1.")
        self.num_outputs = int(num_outputs)
        self.num_latents = int(num_latents) if num_latents is not None \
            else self.num_outputs
        if self.num_latents < 1:
            raise ValueError("num_latents must be >= 1.")
        self.jitter = jitter
        self.whitened = whitened
        if not isinstance(X, Variable):
            X = Variable(value=X)
        if noise_var is None:
            noise_var = Variable(transformation=PositiveTransformation(),
                                 initial_value=0.01)
        elif not isinstance(noise_var, Variable):
            noise_var = Variable(value=noise_var)
        if mixing_matrix is None:
            # a near-orthogonal start keeps the early outputs
            # decorrelated; the JAX package's draw, so both start alike
            rng = np.random.default_rng(0)
            W0 = np.linalg.qr(rng.standard_normal(
                (max(self.num_latents, self.num_outputs),) * 2
            ))[0][:self.num_latents, :self.num_outputs]
            mixing_matrix = Variable(
                shape=(self.num_latents, self.num_outputs),
                initial_value=W0)
        elif not isinstance(mixing_matrix, Variable):
            mixing_matrix = Variable(value=mixing_matrix)
        if inducing_inputs is None:
            inducing_inputs = Variable(
                shape=(num_inducing, kernel.input_dim),
                initial_value=np.random.randn(num_inducing,
                                              kernel.input_dim))
        inputs = [("X", X), ("inducing_inputs", inducing_inputs),
                  ("noise_var", noise_var),
                  ("mixing_matrix", mixing_matrix)]
        super().__init__(inputs=inputs, outputs=None,
                         input_names=[k for k, _ in inputs],
                         output_names=["random_variable"],
                         rand_gen=rand_gen, dtype=dtype)
        self.kernel = kernel

    def _generate_outputs(self, output_shapes=None):
        if output_shapes["random_variable"] is None:
            Y_shape = self.X.shape[:-1] + (self.num_outputs,)
        else:
            Y_shape = output_shapes["random_variable"]
        if Y_shape[-1] != self.num_outputs:
            raise ValueError(
                "output event dim {} != num_outputs {}.".format(
                    Y_shape[-1], self.num_outputs))
        self.set_outputs([Variable(shape=Y_shape)])

    def _build_module_graphs(self):
        Y = self.random_variable
        Q = self.num_latents
        graph = Model(name="lmc_svgp")
        graph.X = self.X.replicate_self()
        graph.inducing_inputs = self.inducing_inputs.replicate_self()
        M = self.inducing_inputs.shape[0]
        graph.noise_var = self.noise_var.replicate_self()
        graph.mixing_matrix = self.mixing_matrix.replicate_self()
        graph.U = GaussianProcess.define_variable(
            X=graph.inducing_inputs, kernel=self.kernel,
            shape=(graph.inducing_inputs.shape[0], Q),
            rand_gen=self._rand_gen, dtype=self.dtype, jitter=self.jitter)
        graph.F = ConditionalGaussianProcess.define_variable(
            X=graph.X, X_cond=graph.inducing_inputs, Y_cond=graph.U,
            kernel=self.kernel, shape=Y.shape[:-1] + (Q,),
            rand_gen=self._rand_gen, dtype=self.dtype, jitter=self.jitter)
        graph.Y = Y.replicate_self()
        graph.Y.set_prior(Normal(
            mean=dot(graph.F, graph.mixing_matrix),
            variance=broadcast_to(graph.noise_var, graph.Y.shape),
            rand_gen=self._rand_gen, dtype=self.dtype))
        graph.kernel = graph.U.factor.kernel
        post = Posterior(graph)
        post.qU_cov_diag = Variable(
            shape=(M,), transformation=PositiveTransformation(),
            initial_value=np.ones(M) * 1e-6)
        post.qU_cov_W = Variable(shape=(M, M), initial_value=np.eye(M))
        post.qU_mean = Variable(shape=(M, Q))
        return graph, [post]

    def _attach_default_inference_algorithms(self):
        observed = [v for _, v in self.inputs] + \
            [v for _, v in self.outputs]
        self.attach_log_pdf_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=LMCSVGPLogPdf(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened),
            alg_name="lmc_svgp_log_pdf")
        observed = [v for _, v in self.inputs]
        self.attach_draw_samples_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=ForwardSamplingAlgorithm(self._module_graph,
                                               observed),
            alg_name="lmc_svgp_sampling")
        self.attach_prediction_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=LMCSVGPMeanVariancePrediction(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened),
            alg_name="lmc_svgp_predict")

    @staticmethod
    def define_variable(X, kernel, num_outputs, shape=None,
                        num_latents=None, noise_var=None,
                        mixing_matrix=None, inducing_inputs=None,
                        num_inducing=10, rand_gen=None, dtype=None,
                        jitter=1e-5, whitened=False):
        gp = LMCSVGPRegression(
            X=X, kernel=kernel, num_outputs=num_outputs,
            num_latents=num_latents, noise_var=noise_var,
            mixing_matrix=mixing_matrix, inducing_inputs=inducing_inputs,
            num_inducing=num_inducing, rand_gen=rand_gen, dtype=dtype,
            jitter=jitter, whitened=whitened)
        gp._generate_outputs({"random_variable": shape})
        return gp.random_variable

    def replicate_self(self, attribute_map=None):
        rep = super().replicate_self(attribute_map)
        rep.kernel = self.kernel.replicate_self(attribute_map)
        if rep._module_graph is not None:
            rep._module_graph.kernel = rep._module_graph.U.factor.kernel
        rep.num_outputs = self.num_outputs
        rep.num_latents = self.num_latents
        rep.jitter = self.jitter
        rep.whitened = self.whitened
        return rep
