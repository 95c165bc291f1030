"""Uncollapsed stochastic variational GP regression (Hensman-style).

Counterpart of ``mxfusion_tpu/modules/gp_modules/svgp_regression.py``.
The posterior holds explicit variational parameters ``q(U) = N(qU_mean,
qU_cov_W qU_cov_Wᵀ + diag(qU_cov_diag))``. So far the module serves:
the predictive moments (standard and whitened parameterization,
diagonal variance or full covariance). The ELBO
(``SVGPRegressionLogPdf``, with the fused gram kernel) and the sampling
algorithms come with the training slice.
"""
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
from ...components.functions.operators import broadcast_to
from ...inference.inference_alg import SamplingAlgorithm
from ...ops.linalg import make_diagonal
from ...ops.precision import einsum as p_einsum


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


class SVGPRegressionMeanVariancePrediction(SamplingAlgorithm):
    """Predictive moments from the explicit q(U)."""

    def __init__(self, model, posterior, observed, noise_free=True,
                 diagonal_variance=True, jitter=0.0, whitened=False):
        super().__init__(model=model, observed=observed,
                         extra_graphs=[posterior])
        self.jitter = jitter
        self.noise_free = noise_free
        self.diagonal_variance = diagonal_variance
        self.whitened = whitened

    @property
    def serving_data_axes(self):
        # (s, N, D) mean + (s, N, 1) diag var | (s, N, N) covariance
        return ((1,), (1,)) if self.diagonal_variance \
            else ((1,), (1, 2))

    def _moments(self, env):
        has_mean = self.model.F.factor.has_mean
        X = env[self.model.X]
        N = X.shape[-2]
        Z = env[self.model.inducing_inputs]
        noise_var = env[self.model.noise_var]
        posterior = self._extra_graphs[0]
        qU_mean = env[posterior.qU_mean]
        S_W = env[posterior.qU_cov_W]
        S_diag = env[posterior.qU_cov_diag]
        M = Z.shape[-2]
        kern = self.model.kernel
        kern_params = kern.fetch_parameters(env)
        X, Z, noise_var, qU_mean, S_W, S_diag, kern_params = \
            arrays_as_samples(
                [X, Z, noise_var, qU_mean, S_W, S_diag, kern_params])

        S = p_einsum("...ik,...jk->...ij", S_W, S_W) + \
            make_diagonal(S_diag)
        Kuu = kern.K(Z, **kern_params)
        if self.jitter > 0.0:
            Kuu = Kuu + torch.eye(M, dtype=Z.dtype, device=Z.device) * \
                self.jitter
        # one batched Cholesky for the two independent M×M factors
        LL = torch.linalg.cholesky(torch.stack([Kuu, S], dim=-3))
        L = LL[..., 0, :, :]
        Ls = LL[..., 1, :, :]
        if self.whitened:
            # u = L v: Linv cancels against the whitened parameters
            LinvLs = Ls
            Linvmu = qU_mean
        else:
            LinvLs = _solve_lower(L, Ls)
            Linvmu = _solve_lower(L, qU_mean)
        LinvSLinvT = p_einsum("...ik,...jk->...ij", LinvLs, LinvLs)
        wv = torch.linalg.solve_triangular(L.mT, Linvmu, upper=True)

        Kxt = kern.K(Z, X, **kern_params)
        mu = p_einsum("...mn,...md->...nd", Kxt, wv)
        if has_mean:
            mu = mu + env[self.model.mean]
        LinvKxt = _solve_lower(L, Kxt)
        if self.diagonal_variance:
            Ktt = kern.Kdiag(X, **kern_params)
            tmp = p_einsum("...mk,...kn->...mn", LinvSLinvT, LinvKxt)
            var = Ktt - torch.sum(torch.square(LinvKxt), dim=-2) + \
                torch.sum(tmp * LinvKxt, dim=-2)
            var = torch.unsqueeze(var, -1)
            if not self.noise_free:
                var = var + noise_var
        else:
            Ktt = kern.K(X, **kern_params)
            tmp = p_einsum("...mk,...kn->...mn", LinvSLinvT, LinvKxt)
            var = Ktt - \
                p_einsum("...mn,...mk->...nk", LinvKxt, LinvKxt) + \
                p_einsum("...mn,...mk->...nk", LinvKxt, tmp)
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


class SVGPRegression(Module):
    """SVGP regression module."""

    def __init__(self, X, kernel, noise_var, inducing_inputs=None,
                 num_inducing=10, mean=None, rand_gen=None, dtype=None,
                 jitter=1e-5, whitened=False):
        self.jitter = jitter
        self.whitened = whitened
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
        graph = Model(name="svgp_regression")
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
        post.qU_cov_diag = Variable(
            shape=(M,), transformation=PositiveTransformation(),
            initial_value=np.ones(M) * 1e-6)
        post.qU_cov_W = Variable(shape=(M, M),
                                 initial_value=np.eye(M))
        post.qU_mean = Variable(shape=(M, Y.shape[-1]))
        return graph, [post]

    def _attach_default_inference_algorithms(self):
        observed = [v for _, v in self.inputs]
        self.attach_prediction_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=SVGPRegressionMeanVariancePrediction(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened),
            alg_name="svgp_predict")

    def log_pdf(self, env, targets=None, ctx=None):
        raise NotImplementedError(
            "SVGPRegression.log_pdf is not ported yet: the ELBO "
            "(SVGPRegressionLogPdf and its fused gram kernel) comes with "
            "the training slice of mxfusion_tpu_torch.")

    def draw_samples(self, env, generator, num_samples=1, targets=None):
        raise NotImplementedError(
            "SVGPRegression.draw_samples is not ported yet: the sampling "
            "algorithms come with the training slice of "
            "mxfusion_tpu_torch.")

    @staticmethod
    def define_variable(X, kernel, noise_var, shape=None,
                        inducing_inputs=None, num_inducing=10, mean=None,
                        rand_gen=None, dtype=None, jitter=1e-5,
                        whitened=False):
        gp = SVGPRegression(
            X=X, kernel=kernel, noise_var=noise_var,
            inducing_inputs=inducing_inputs, num_inducing=num_inducing,
            mean=mean, rand_gen=rand_gen, dtype=dtype, jitter=jitter,
            whitened=whitened)
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
        rep.whitened = self.whitened
        return rep
