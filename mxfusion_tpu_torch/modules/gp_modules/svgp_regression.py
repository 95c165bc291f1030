"""Uncollapsed stochastic variational GP regression (Hensman-style).

Counterpart of ``mxfusion_tpu/modules/gp_modules/svgp_regression.py``.
The posterior holds explicit variational parameters ``q(U) = N(qU_mean,
qU_cov_W qU_cov_Wᵀ + diag(qU_cov_diag))``; the ELBO is

    log_pdf_scaling · E_q[log N(Y | KfuKuu⁻¹U, σ²)] − KL(q(U) ‖ p(U))

(:class:`SVGPRegressionLogPdf`, standard and whitened), with the data
terms minibatchable. On the wide RBF data path the bound calls the fused
L⁻¹·Kuf gram (``ops/fused_gram.py``, K2 and K3 on the card). The module
also serves predictive moments and samples, and draws from its prior
by forward sampling of the module graph (``svgp_sampling``).
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
from ...components.functions.operators import broadcast_to
from ...inference.variational import VariationalInference
from ...inference.inference_alg import SamplingAlgorithm
from ...inference.forward_sampling import ForwardSamplingAlgorithm
from ...inference import param_memo
from ...ops import fused_gram
from ...ops.linalg import (broadcast_to_w_samples, cholesky, make_diagonal,
                           triangular_inverse, wide_triangular_solve)
from ...ops.precision import einsum as p_einsum
from ...ops.precision import (data_einsum, data_precision_scope,
                              get_data_precision, guarded_data_einsum,
                              guarded_forward_matmul)
from ...util.profiling import span

LOG2PI = math.log(2.0 * math.pi)


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def _solve_lower_t(L, B):
    """``L⁻ᵀ·B`` (JAX: ``solve_triangular(L, B, lower=True, trans="T")``)."""
    return torch.linalg.solve_triangular(L.mT, B, upper=True)


def _log_diag_sum(L):
    return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


class SVGPRegressionLogPdf(VariationalInference):
    """Uncollapsed SVGP ELBO.

    ``whitened=True`` parameterizes q over the whitened inducing values
    v = L⁻¹u (u = L v, L = chol(Kuu)), whose KL term is against N(0, I).
    Every branch is the JAX package's (``svgp_regression.py:43-220``):
    narrow/wide solves, the reuse of L⁻¹, the fused arm, the
    residual-form data fit and the guarded products.
    """

    def __init__(self, model, posterior, observed, jitter=0.0,
                 whitened=False):
        super().__init__(num_samples=1, model=model, posterior=posterior,
                         observed=observed)
        self.log_pdf_scaling = 1.0
        self.jitter = jitter
        self.whitened = whitened

    def compute(self, env, ctx):
        with span("svgp.bound"):
            return self._bound(env)

    def _bound(self, env):
        from ...components.distributions.gp.kernels import RBF
        has_mean = self.model.F.factor.has_mean
        X = env[self.model.X]
        Y = env[self.model.Y]
        Z = env[self.model.inducing_inputs]
        noise_var = env[self.model.noise_var]
        mu = env[self.posterior.qU_mean]
        S_W = env[self.posterior.qU_cov_W]
        S_diag = env[self.posterior.qU_cov_diag]
        D = Y.shape[-1]
        M = Z.shape[-2]
        kern = self.model.kernel
        kern_params = kern.fetch_parameters(env)
        X, Y, Z, noise_var, mu, S_W, S_diag, kern_params = arrays_as_samples(
            [X, Y, Z, noise_var, mu, S_W, S_diag, kern_params])

        if noise_var.ndim == 2:
            # homoscedastic (s, 1) -> (s, 1, 1); heteroscedastic stays
            # (s, N, 1) or (s, N, D)
            noise_var = torch.unsqueeze(noise_var, -2)
        if noise_var.shape[-1] == 1:
            beta_sum = D * torch.sum(1.0 / noise_var, dim=-1)   # (s, N|1)
        else:
            beta_sum = torch.sum(1.0 / noise_var, dim=-1)

        Kuu = kern.K(Z, **kern_params)
        if self.jitter > 0.0:
            Kuu = Kuu + torch.eye(M, dtype=Z.dtype, device=Z.device) * \
                self.jitter
        N = X.shape[-2]
        wide = N >= 4 * M
        # the fused arm: Kuf is never materialized (K2/K3 on the card).
        # Exact class identity, not isinstance: a subclass may override
        # _compute_K, and the kernels hard-code the plain RBF gram.
        use_fused = (fused_gram.enabled() and wide
                     and X.shape[0] == 1
                     and type(kern) is RBF
                     and getattr(kern, "active_dims", None) is None
                     and fused_gram.supported(M, N, X.shape[-1], X.dtype,
                                              X.device))
        Kuf = None if use_fused else kern.K(Z, X, **kern_params)
        Kff_diag = kern.Kdiag(X, **kern_params)

        S = p_einsum("...ik,...jk->...ij", S_W, S_W) + \
            make_diagonal(S_diag)

        if has_mean:
            Y = Y - env[self.model.mean]

        # one batched Cholesky for the two independent M×M factors
        LL = cholesky(torch.stack([Kuu, S], dim=-3))
        L = LL[..., 0, :, :]
        Ls = LL[..., 1, :, :]
        Linv = None
        if use_fused or (wide and not self.whitened):
            # the wide data solve materializes L⁻¹ anyway: reuse it for
            # the narrow solves too (the fused kernel consumes it)
            Linv = triangular_inverse(L, lower=True)
        if self.whitened:
            # q parameterizes v = L⁻¹u directly: the L-solves and the
            # prior logdet correction drop out of the bound
            LinvLs = Ls
            Linvmu = mu
        elif Linv is not None:
            LinvLs = p_einsum("...ij,...jk->...ik", Linv, Ls)
            Linvmu = p_einsum("...ij,...jk->...ik", Linv, mu)
        else:
            LinvLs = _solve_lower(L, Ls)
            Linvmu = _solve_lower(L, mu)
        if use_fused:
            kp = kern._strip_prefix(kern_params)
            ls = kp["lengthscale"][0]
            var = kp["variance"][0].reshape(())
            LinvKuf = fused_gram.fused_linv_rbf_gram(
                Linv[0].contiguous(), Z[0] / ls, X[0] / ls, var,
                lower=True)[None]
        elif Linv is not None:
            LinvKuf = guarded_forward_matmul(Linv, Kuf)
        else:
            LinvKuf = wide_triangular_solve(L, Kuf, lower=True)

        # predictive-mean path m = Kufᵀ(Kuu⁻¹mu), associated through the
        # narrow w-vector at the guarded tier: its rounding enters the
        # bound as R·δm/σ² with |R| → σ at convergence
        if use_fused:
            # Kuf does not exist: associate through G (same quantity)
            KfuKuuInvmu = guarded_data_einsum("...mn,...md->...nd",
                                              LinvKuf, Linvmu)
        else:
            if Linv is not None and not self.whitened:
                w_vec = p_einsum("...ji,...jk->...ik", Linv, Linvmu)
            else:
                w_vec = _solve_lower_t(L, Linvmu)
            KfuKuuInvmu = guarded_data_einsum("...mn,...md->...nd",
                                              Kuf, w_vec)
        KfuKuuInvLs = data_einsum("...mn,...mk->...nk", LinvKuf, LinvLs)

        sumlogdiag_Ls = _log_diag_sum(Ls)
        if self.whitened:
            sumlogdiag_L_D = 0.0
        else:
            sumlogdiag_L_D = _log_diag_sum(L) * D
        # negative KL(q || p), summed over output columns
        KL_u = (M / 2.0 + sumlogdiag_Ls) * D - sumlogdiag_L_D \
            - torch.sum(torch.square(LinvLs), dim=(-2, -1)) / 2.0 * D \
            - torch.sum(torch.square(Linvmu), dim=(-2, -1)) / 2.0

        # residual-form data fit (svgp_regression.py:198-209 there): the
        # residual R = Y − m is formed elementwise, so the term's rounding
        # scales with |R| and not with |Y|; Kff and qff are grouped per
        # point before the β-weighted reduction
        R = Y - KfuKuuInvmu                                   # (s, N, D)
        qff_diag = torch.sum(torch.square(LinvKuf), dim=-2)   # (s, N)
        logL = -torch.sum(torch.square(R) / noise_var + LOG2PI +
                          torch.log(noise_var), dim=(-2, -1)) / 2.0
        logL = logL - torch.sum((Kff_diag - qff_diag) * beta_sum,
                                dim=-1) / 2.0
        logL = logL - torch.sum(
            torch.square(KfuKuuInvLs) * torch.unsqueeze(beta_sum, -1),
            dim=(-2, -1)) / 2.0
        return self.log_pdf_scaling * logL + KL_u


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

    def _factors(self, Z, qU_mean, S_W, S_diag, kern_params):
        """What the moments need of the parameters alone: L = chol(Kuu),
        L⁻¹SL⁻ᵀ and wv = Kuu⁻¹·qU_mean (whitened: L⁻ᵀ·qU_mean)."""
        with span("svgp.factors"):
            kern = self.model.kernel
            M = Z.shape[-2]
            S = p_einsum("...ik,...jk->...ij", S_W, S_W) + \
                make_diagonal(S_diag)
            Kuu = kern.K(Z, **kern_params)
            if self.jitter > 0.0:
                Kuu = Kuu + torch.eye(M, dtype=Z.dtype, device=Z.device) * \
                    self.jitter
            # one batched Cholesky for the two independent M×M factors
            LL = cholesky(torch.stack([Kuu, S], dim=-3))
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
            return L, LinvSLinvT, wv

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
        kern = self.model.kernel
        kern_params = kern.fetch_parameters(env)
        # the env tensors the factors are built from, as the env holds them
        sources = (Z, qU_mean, S_W, S_diag) + tuple(kern_params.values())
        X, Z, noise_var, qU_mean, S_W, S_diag, kern_params = \
            arrays_as_samples(
                [X, Z, noise_var, qU_mean, S_W, S_diag, kern_params])

        # the factors depend on the parameters only, the moments on the
        # rows: two spans, so that a trace tells their costs apart. Inside
        # a predictor's memo scope the factors are built once for a set
        # of parameters and kept while those tensors are unchanged
        L, LinvSLinvT, wv = param_memo.derived(
            self, (self.jitter, self.whitened, get_data_precision(),
                   Z.shape[0]), sources,
            lambda: self._factors(Z, qU_mean, S_W, S_diag, kern_params))

        with span("svgp.moments"):
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
                    var = var + torch.eye(N, dtype=X.dtype,
                                          device=X.device) * \
                        torch.unsqueeze(noise_var, -2)
            return mu, var

    def compute(self, env, ctx):
        mu, var = self._moments(env)
        outcomes = {self.model.Y.uuid: (mu, var)}
        if self.target_variables:
            return tuple(outcomes[v] for v in self.target_variables)
        return outcomes


class SVGPRegressionSamplingPrediction(SVGPRegressionMeanVariancePrediction):
    """Predictive sampling: mean plus noise shaped by the diagonal
    variance, or by the Cholesky factor of the full covariance."""

    serving_data_axes = ((1,),)  # one (s, N, D) samples leaf

    def __init__(self, model, posterior, observed, rand_gen=None,
                 noise_free=True, diagonal_variance=True, jitter=0.0,
                 whitened=False):
        super().__init__(model=model, posterior=posterior, observed=observed,
                         noise_free=noise_free,
                         diagonal_variance=diagonal_variance, jitter=jitter,
                         whitened=whitened)
        from ...components.distributions.random_gen import default_rand_gen
        self._rand_gen = rand_gen if rand_gen is not None \
            else default_rand_gen()

    def compute(self, env, ctx):
        if self.diagonal_variance:
            mu, var = self._moments(env)
        else:
            # the full predictive covariance feeds a Cholesky below: pin
            # HIGHEST even when the data-side precision is relaxed
            with data_precision_scope("highest"):
                mu, var = self._moments(env)
        out_shape = (self.num_samples,) + tuple(mu.shape[1:])
        die = self._rand_gen.sample_normal(
            ctx.next_generator(), shape=out_shape,
            dtype=self.model.F.factor.dtype)
        if self.diagonal_variance:
            samples = mu + die * torch.sqrt(torch.clamp(var, min=0.0))
        else:
            Lc = broadcast_to_w_samples(
                cholesky(var),
                out_shape[1:-1] + out_shape[-2:-1], self.num_samples)
            samples = mu + p_einsum("...ij,...jk->...ik", Lc, die)
        outcomes = {self.model.Y.uuid: samples}
        if self.target_variables:
            return tuple(outcomes[v] for v in self.target_variables)
        return outcomes


class SVGPRegression(Module):
    """SVGP regression module."""

    #: the bound's data term is a sum over rows (the KL is global)
    row_separable = True

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
        observed = [v for _, v in self.inputs] + \
            [v for _, v in self.outputs]
        self.attach_log_pdf_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=SVGPRegressionLogPdf(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened),
            alg_name="svgp_log_pdf")
        observed = [v for _, v in self.inputs]
        self.attach_draw_samples_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=ForwardSamplingAlgorithm(self._module_graph, observed),
            alg_name="svgp_sampling")
        self.attach_prediction_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=SVGPRegressionMeanVariancePrediction(
                self._module_graph, self._extra_graphs[0], observed,
                jitter=self.jitter, whitened=self.whitened),
            alg_name="svgp_predict")

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
