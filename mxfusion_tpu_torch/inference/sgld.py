"""Stochastic-gradient Langevin dynamics (SGLD) posterior sampling.

Counterpart of ``mxfusion_tpu/inference/sgld.py``. The gradient of the
log-joint is estimated on minibatches gathered on the data's device
with the N/B likelihood rescaling (the same ``log_pdf_scaling`` plumbing
the minibatch SVI loop uses), so one chain step costs one minibatch
gradient instead of a full-data pass (Welling & Teh 2011). Optional
RMSProp preconditioning (pSGLD, Li et al. 2016) handles latents with
very different posterior scales. Chains ride the sample axis; the chain
is a Python loop over steps, each a private function of its draws
(minibatch indices, Langevin noise).
"""
import numpy as np
import torch

from .inference import Inference
from .inference_alg import (SamplingAlgorithm, VariableEnv,
                            create_sampling_executor)
from .hmc import (HMCInference, _chain_convergence_diagnostics,
                  _normal_draws, _stack, _as_numpy, detached_env,
                  init_chains_from_prior, log_posterior,
                  make_support_transforms, sampler_latent_uuids,
                  value_and_grad)
from ..common.exceptions import InferenceError
from ..util.inference import discover_shape_constants


def _sgld_step(q, V, g, noise, eps, preconditioning, alpha, lam):
    """One (p)SGLD update of every chain on explicit draws: ``g`` the
    stochastic gradient of the log joint at q, ``noise`` standard
    normals shaped like q, ``V`` the RMSProp moving average. Returns
    (q, V)."""
    qn, Vn = {}, {}
    for u in q:
        if preconditioning:
            Vn[u] = alpha * V[u] + (1.0 - alpha) * g[u] ** 2
            P = 1.0 / (lam + torch.sqrt(Vn[u]))
        else:
            Vn[u] = V[u]
            P = 1.0
        qn[u] = q[u] + 0.5 * eps * P * g[u] + torch.sqrt(eps * P) * noise[u]
    return qn, Vn


class SGLDAlgorithm(SamplingAlgorithm):
    """SGLD sampling of the model's latent RANDVARs.

    Parameters
    ----------
    num_samples : int
        Kept (post-burn-in, thinned) draws per chain.
    num_burnin : int
        Discarded leading steps.
    thin : int
        Chain steps per kept draw.
    num_chains : int
        Chains, vectorized on the sample axis (prior-initialized).
    batch_size : int or None
        Minibatch rows per step; ``None`` runs full-batch (unadjusted
        Langevin). The likelihood is rescaled by N/B via
        ``log_pdf_scaling`` (set by ``SGLDInference``'s executor).
    step_size : float
        Base step size ``a`` of the Welling–Teh schedule
        ``eps_t = a * (1 + t/b) ** (-gamma)``.
    step_decay_b, step_decay_gamma : float
        Schedule parameters; ``gamma=0`` keeps the step constant.
    preconditioning : bool
        RMSProp-preconditioned SGLD (pSGLD): per-dimension adaptive
        scaling ``1/(lambda + sqrt(V))`` with ``V`` an exponential
        moving average of squared stochastic gradients. The update omits
        the curvature drift term ``Gamma(theta)`` of Li et al. 2016
        (eq. 5), the standard practical simplification, as in JAX.
    precond_alpha, precond_lambda : float
        pSGLD EMA rate and damping.

    ``compute`` returns ``(samples, diagnostics)`` like HMC: samples is
    {uuid: (num_samples, num_chains, *event_shape)}; diagnostics holds
    the final step size and final per-chain minibatch log-joint.
    """

    def __init__(self, model, observed, num_samples=1000, num_burnin=500,
                 thin=1, num_chains=4, batch_size=None, step_size=1e-3,
                 step_decay_b=1000.0, step_decay_gamma=0.55,
                 preconditioning=False, precond_alpha=0.99,
                 precond_lambda=1e-5, target_variables=None,
                 extra_graphs=None):
        super().__init__(model=model, observed=observed,
                         num_samples=num_samples,
                         target_variables=target_variables,
                         extra_graphs=extra_graphs)
        self.num_burnin = num_burnin
        self.thin = thin
        self.num_chains = num_chains
        self.batch_size = batch_size
        self.step_size = step_size
        self.step_decay_b = step_decay_b
        self.step_decay_gamma = step_decay_gamma
        self.preconditioning = preconditioning
        self.precond_alpha = precond_alpha
        self.precond_lambda = precond_lambda

    def _latent_uuids(self):
        return sampler_latent_uuids(self, "SGLD")

    def _data_rows(self, env):
        """N, the one leading data dimension of the observed arrays;
        raises when they disagree or B exceeds it."""
        n_rows = {env[u].shape[1] for u in self.observed_variable_UUIDs
                  if env[u].ndim >= 2}
        if len(n_rows) != 1:
            raise InferenceError(
                "SGLD minibatching expects every observed array to share "
                "one leading data dimension; got sizes {}. Use "
                "batch_size=None for full-batch Langevin.".format(
                    sorted(n_rows)))
        (N,) = n_rows
        if self.batch_size > N:
            raise InferenceError("batch_size {} exceeds the data size {}."
                                 .format(self.batch_size, N))
        return N

    @staticmethod
    def _batch_env(env, observed, idx, N):
        """``env`` with each observed array of N data rows replaced by
        its rows ``idx`` (a gather on the data's device)."""
        be = VariableEnv(env)
        for u in observed:
            if env[u].ndim >= 2 and env[u].shape[1] == N:
                be[u] = torch.index_select(env[u], 1, idx)
        return be

    def _step_size_at(self, t, like):
        """The Welling–Teh step size after ``t`` steps."""
        a = torch.as_tensor(self.step_size, dtype=like.dtype,
                            device=like.device)
        if self.step_decay_gamma == 0.0:
            return a
        return a * (1.0 + t / self.step_decay_b) ** (-self.step_decay_gamma)

    @property
    def reduces_over_data(self):
        """Full-batch Langevin's potentials go through value_and_grad
        (see HMCAlgorithm); minibatches draw rows, so split data is
        gathered for them."""
        return self.batch_size is None

    def compute(self, env, ctx):
        C = self.num_chains
        latent_uuids = self._latent_uuids()
        observed = list(self.observed_variable_UUIDs)
        env = detached_env(env)
        generator = ctx.next_generator()
        # chains initialized by ancestral prior draws (C on sample axis)
        q = init_chains_from_prior(self.model, env, generator,
                                   latent_uuids, C)
        first = q[latent_uuids[0]]
        dtype, device = first.dtype, first.device
        bij = make_support_transforms(self.model, latent_uuids)
        if bij is not None:
            q = bij.unconstrain(q)
        B = self.batch_size
        N = self._data_rows(env) if B is not None else None

        def batch_env_at():
            if B is None:
                return env
            idx = torch.randint(0, N, (B,), generator=generator,
                                device=device)
            return self._batch_env(env, observed, idx, N)

        def step(q, V, t):
            # the bijector's log|J| is prior-side: it is not rescaled
            # by N/B (log_pdf_scaling touches the likelihood only)
            _, g = value_and_grad(
                log_posterior(self.model, batch_env_at(), ctx, bij, dtype),
                q, ctx.data_reduction)
            noise = _normal_draws(q, generator)
            return _sgld_step(q, V, g, noise, self._step_size_at(t, first),
                              self.preconditioning, self.precond_alpha,
                              self.precond_lambda)

        with torch.no_grad():
            V = {u: torch.zeros_like(v) for u, v in q.items()}
            t = 0
            for _ in range(self.num_burnin):
                q, V = step(q, V, t)
                t += 1
            draws = []
            for _ in range(self.num_samples):
                for _ in range(self.thin):
                    q, V = step(q, V, t)
                    t += 1
                draws.append(q)
            chain = _stack(draws)
            if bij is not None:
                chain = bij.constrain(chain)  # back to the native support
            final_lp = log_posterior(self.model, batch_env_at(), ctx, bij,
                                     dtype)(q)
            if ctx.data_reduction is not None:
                final_lp, _ = ctx.data_reduction(final_lp, {})
        targets = self.target_variables if self.target_variables \
            else latent_uuids
        samples = {u: chain[u] for u in targets}
        diagnostics = {
            "step_size_final": self._step_size_at(t - 1, first),
            "final_minibatch_log_joint": final_lp,
        }
        return samples, diagnostics


class SGLDInference(Inference):
    """The inference: ``run(**data)`` returns the posterior sample dict and
    stores ``.diagnostics``. Applies the N/B likelihood rescaling to
    every observed RANDVAR's generating factor.

    Example::

        alg = SGLDAlgorithm(model=m, observed=[m.y], batch_size=256,
                            num_samples=2000, num_chains=4)
        infr = SGLDInference(alg)
        samples = infr.run(y=y)[w_uuid]      # (2000, 4, *event)
    """

    def run(self, generator=None, **kwargs):
        data = self._fetch_observed(kwargs)
        alg = self._algorithm
        rv_scaling = None
        if alg.batch_size is not None:
            # symbolic data dims bind to the BATCH size (the convention
            # of the minibatch loops): the likelihood subgraph evaluates
            # on B-row slices, so a model minibatched by SGLD declares
            # its data axis with a symbolic dim (m.n = Variable())
            B = alg.batch_size
            data_shapes = {uuid: (min(B, np.shape(d)[0]),) +
                           tuple(np.shape(d)[1:])
                           for uuid, d in zip(self.observed_variable_UUIDs,
                                              data)}
            self.params.constants.update(
                discover_shape_constants(data_shapes, self.graphs))
            self.params.initialize_params(
                self.graphs, self.observed_variable_UUIDs,
                generator=generator)
            self._initialized = True
            N = np.shape(data[0])[0]
            rv_scaling = {u: N / float(B)
                          for u in alg.observed_variable_UUIDs}
        elif not self._initialized:
            self.initialize(generator=generator, **kwargs)
        if generator is None:
            generator = torch.Generator(
                device=self.params.device).manual_seed(0)
        executor = create_sampling_executor(alg, self.params,
                                            rv_scaling=rv_scaling)
        samples, diagnostics = executor(
            self.params.trainable_params(), self.params.fixed_params(),
            data, generator)
        self.diagnostics = {k: _as_numpy(v) for k, v in diagnostics.items()}
        self.diagnostics.update(_chain_convergence_diagnostics(samples))
        self._samples = samples
        return samples


# posterior-predictive sampling works as HMC's: latents pinned to the
# stored draws, ancestral sampling of the rest
SGLDInference.sample_predictive = HMCInference.sample_predictive
