"""Natural-gradient optimization of SVGP variational parameters.

Counterpart of ``mxfusion_tpu/inference/natural_gradient.py``.
Natural-gradient descent on q(U)'s natural parameters (Salimbeni et al.
2018) takes the exact information-geometry step for the Gaussian family:
for a conjugate likelihood at fixed hyperparameters, γ = 1 reaches the
optimal q(U) in one step.

The update (minimizing loss = −ELBO), for q(U) = Π_d N(m_d, S) with one
covariance over D output columns:

    θ1 = S⁻¹ m,          θ2 = −½ S⁻¹                   (natural)
    η1 = m,              η2 = D·S + Σ_d m_d m_dᵀ        (expectation)
    dL/dη1 = g_m − (2/D) g_S m,   dL/dη2 = g_S / D
    θ ← θ − γ dL/dη  →  S' = (S⁻¹ + 2γ g_S/D)⁻¹,  m' = S' θ1'

where (g_m, g_S) are the loss's gradients in (m, S), S a full symmetric
matrix: m and S are leaf tensors of their own, and the loss sees
``qU_cov_W = chol(½(S + Sᵀ))`` with the redundant diagonal frozen at the
jitter. The hyperparameters (kernel, noise, Z) take a simultaneous
``torch.optim`` step on the same evaluation.

The factors go through ``ops.linalg.cholesky`` (NaN for a matrix that is
not positive definite, as ``jnp.linalg.cholesky``) and
``torch.cholesky_solve``; a step whose result holds a NaN keeps the old
(m, S), as the JAX guard does. Each loop counts the guard's trips
(``guard_trips``): the guard keeps a run going, and the count says how
often it had to.
"""
import time

import torch

from .grad_loop import GradLoop, _global_norm, make_optimizer
from .device_loop import DeviceMinibatchLoop
from ..common.exceptions import InferenceError
from ..ops.linalg import cholesky
from ..ops.precision import einsum as p_einsum


def _check_not_whitened(module):
    if getattr(module, "whitened", False):
        raise InferenceError(
            "Natural-gradient loops require the non-whitened SVGP "
            "parameterization (whitened NGD is not implemented).")


def _qu_uuids(module):
    post = module._extra_graphs[0]
    return (post.qU_mean.uuid, post.qU_cov_W.uuid,
            post.qU_cov_diag.uuid, post.qU_cov_diag.transformation)


def _sym(A):
    return 0.5 * (A + A.mT)


def _ngd_update(m, S, g_m, g_S, gamma, jitter, eye, D):
    """One natural-gradient step on q(U) = Π_d N(m_d, S): the updated
    (m, S), or the old ones where the result holds a NaN, and whether the
    guard kept them (a 0-d bool tensor)."""
    g_S = _sym(g_S)
    LS = cholesky(S)
    Sinv = torch.cholesky_solve(eye, LS)
    theta1_new = Sinv @ m - gamma * (g_m - (2.0 / D) * (g_S @ m))
    P = Sinv + (2.0 * gamma / D) * g_S
    P = _sym(P) + jitter * eye
    LP = cholesky(P)
    S_new = _sym(torch.cholesky_solve(eye, LP))
    m_new = S_new @ theta1_new
    bad = torch.any(torch.isnan(S_new)) | torch.any(torch.isnan(m_new))
    return torch.where(bad, m, m_new), torch.where(bad, S, S_new), bad


def _frozen_diag(d_un, diag_trans, jitter):
    """The unconstrained value whose transform is ``jitter``, in
    ``d_un``'s shape: the frozen diagonal of q(U)'s covariance."""
    return torch.full_like(d_un, float(diag_trans.inverse_transform(
        torch.full((), jitter, dtype=d_un.dtype))))


class NaturalGradientLoop(GradLoop):
    """Full-batch loop: NGD on an SVGP module's q(U), ``torch.optim`` on
    the rest.

    Parameters
    ----------
    module : the SVGP regression factor (``m.Y.factor``), not whitened
        (NGD is defined on the unwhitened q(U)).
    nat_learning_rate : γ of the natural-gradient step (1 is the exact
        coordinate-ascent step for a conjugate likelihood; 0.1 is robust).
    steps_per_call : the callback sees every step; ``verbose`` and
        ``metrics_callback`` see each chunk of this many steps (means over
        the chunk), as the JAX loop's scanned calls.
    """

    def __init__(self, module, nat_learning_rate=0.1, steps_per_call=1,
                 jitter=1e-10, metrics_callback=None):
        _check_not_whitened(module)
        self.module = module
        self.nat_learning_rate = nat_learning_rate
        self.steps_per_call = steps_per_call
        self.jitter = jitter
        self.metrics_callback = metrics_callback
        # steps whose update the NaN guard refused, over all runs
        self.guard_trips = 0

    def run(self, executor, params, data, optimizer="adam",
            learning_rate=1e-2, max_iter=1000, generator=None,
            verbose=False, callback=None, data_sharding=None,
            resume_state=None):
        """``data_sharding``: one ``parallel.Sharding`` per array, as
        :class:`~.batch_loop.BatchInferenceLoop` takes it."""
        if resume_state is not None:
            raise InferenceError(
                "Deterministic resume is not implemented for "
                "NaturalGradientLoop: its live state includes the "
                "(m, S) natural parameters, which checkpoints do not "
                "capture mid-run. Re-run from scratch or use a "
                "standard loop for resumable training.")
        u_mean, u_w, u_diag, diag_trans = _qu_uuids(self.module)
        trainable = {k: v.detach().clone()
                     for k, v in params.trainable_params().items()}
        fixed = dict(params.fixed_params())
        for u in (u_mean, u_w, u_diag):
            if u not in trainable:
                raise InferenceError(
                    "q(U) parameter {} is not trainable; "
                    "NaturalGradientLoop needs all three q(U) "
                    "parameters free.".format(u))
        m = trainable.pop(u_mean)
        W0 = trainable.pop(u_w)
        d0_uncon = trainable.pop(u_diag)
        # absorb the redundant diagonal into the full S, then freeze it
        # at the jitter (the executor applies the softplus to this value)
        S = p_einsum("ik,jk->ij", W0, W0) + torch.diag(
            diag_trans.transform(d0_uncon))
        frozen_diag = _frozen_diag(d0_uncon, diag_trans, self.jitter)
        eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
        D = float(m.shape[-1])
        hyper = {k: v.requires_grad_(True) for k, v in trainable.items()}
        # torch.optim refuses an empty parameter list; with every
        # hyperparameter fixed there is nothing for it to do
        opt = make_optimizer(optimizer, learning_rate,
                             list(hyper.values())) if hyper else None
        if generator is None:
            generator = torch.Generator(device=params.device).manual_seed(0)
        executor, data = self._full_batch(executor, data, data_sharding,
                                          params.device)
        metrics_cb = self.metrics_callback
        trips = torch.zeros((), dtype=torch.int64, device=S.device)

        def one_step(m, S):
            m = m.detach().requires_grad_(True)
            S = S.detach().requires_grad_(True)
            if opt is not None:
                opt.zero_grad(set_to_none=True)
            W = cholesky(_sym(S))
            tr = {**hyper, u_mean: m, u_w: W, u_diag: frozen_diag}
            loss, loss_for_grad, _ = executor(tr, fixed, data, generator)
            loss_for_grad.backward()
            loss = self._reduce(loss.detach(), [m, S, *hyper.values()])
            g_m, g_S = m.grad, S.grad
            gnorm = None
            if metrics_cb is not None:
                gnorm = _global_norm([v.grad for v in hyper.values()
                                      if v.grad is not None] + [g_m, g_S])
            with torch.no_grad():
                m_new, S_new, bad = _ngd_update(
                    m, S, g_m, g_S, self.nat_learning_rate, self.jitter,
                    eye, D)
            if opt is not None:
                opt.step()
            return m_new, S_new, bad, loss.detach(), gnorm

        k = max(1, self.steps_per_call)
        loss = None
        for c in range(-(-max_iter // k)):
            t0 = time.perf_counter()
            losses, gnorms = [], []
            for _ in range(k):
                m, S, bad, loss, gnorm = one_step(m, S)
                trips += bad
                losses.append(loss)
                gnorms.append(gnorm)
            if verbose:
                print("Iteration {} loss: {}".format(
                    min((c + 1) * k, max_iter), float(loss)))
            if callback is not None:
                for i, l in enumerate(losses):
                    callback(c * k + i, float(l))
            if metrics_cb is not None:
                metrics_cb(c, {
                    "loss": float(torch.mean(torch.stack(losses))),
                    "grad_norm": float(torch.mean(torch.stack(gnorms))),
                    "step_time_s": time.perf_counter() - t0})
        self.guard_trips += int(trips)
        # write the optimized state back in the executor's native
        # parameterization
        S = _sym(S)
        # the NGD state (m, S) is not checkpoint-resumable: clear any
        # TrainState an earlier loop published, so a snapshot cannot pair
        # these parameters with stale optimizer moments
        params.train_state = None
        params.update_params({k: v.detach().clone()
                              for k, v in hyper.items()})
        params.update_params({u_mean: m.detach().clone(),
                              u_w: cholesky(S),
                              u_diag: frozen_diag})
        self._finish()
        return loss.cpu().numpy() if loss is not None else None


class NaturalGradientMinibatchLoop(DeviceMinibatchLoop):
    """Device-resident minibatch SVI with natural-gradient q(U) updates.

    ``rv_scaling = N/B`` makes each minibatch loss an unbiased estimate
    of the full ELBO, so each step's natural gradient is unbiased:
    stochastic NGD (use a smaller ``nat_learning_rate`` than full batch,
    about 0.1). The hyperparameters take the optimizer's step on the same
    evaluation. The dataset, the permutations and the epochs are
    :class:`DeviceMinibatchLoop`'s; only the step differs.
    """

    def __init__(self, module, batch_size=100, rv_scaling=None,
                 nat_learning_rate=0.1, jitter=1e-10,
                 metrics_callback=None, shard_local_shuffle=False):
        _check_not_whitened(module)
        super().__init__(batch_size=batch_size, rv_scaling=rv_scaling,
                         metrics_callback=metrics_callback,
                         shard_local_shuffle=shard_local_shuffle)
        self.module = module
        self.nat_learning_rate = nat_learning_rate
        self.jitter = jitter
        self._trips = None

    @property
    def guard_trips(self):
        """Steps whose update the NaN guard refused, over all runs."""
        return 0 if self._trips is None else int(self._trips)

    def _step(self, executor, opt, trainable, fixed, batch, generator,
              grad_norm=False):
        u_mean, u_w, u_diag, diag_trans = _qu_uuids(self.module)
        jitter = self.jitter
        with torch.no_grad():
            W = trainable[u_w]
            d_un = trainable[u_diag]
            S = p_einsum("ik,jk->ij", W, W) + torch.diag(
                diag_trans.transform(d_un))
            eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
            frozen = _frozen_diag(d_un, diag_trans, jitter)
        m = trainable[u_mean].detach().clone().requires_grad_(True)
        S = S.requires_grad_(True)
        hyper = {k: v for k, v in trainable.items()
                 if k not in (u_mean, u_w, u_diag)}
        opt.zero_grad(set_to_none=True)
        Wc = cholesky(_sym(S))
        tr = {**hyper, u_mean: m, u_w: Wc, u_diag: frozen}
        loss, loss_for_grad, aux = executor(tr, fixed, batch, generator)
        loss_for_grad.backward()
        loss = self._reduce(loss.detach(), [m, S, *hyper.values()])
        g_m, g_S = m.grad, S.grad
        D = float(m.shape[-1])
        with torch.no_grad():
            m_new, S_new, bad = _ngd_update(
                m, S, g_m, g_S, self.nat_learning_rate, jitter, eye, D)
        gnorm = None
        if grad_norm:
            gnorm = _global_norm([v.grad for v in hyper.values()
                                  if v.grad is not None] + [g_m, g_S])
        # the JAX loop runs optax over the full structure with the q(U)
        # gradients zeroed and then overwrites q(U); here the q(U) leaves
        # have no gradient (None), so the optimizer skips them and steps
        # the hyperparameters exactly as optax does
        opt.step()
        with torch.no_grad():
            trainable[u_mean].copy_(m_new)
            trainable[u_w].copy_(cholesky(S_new + jitter * eye))
            trainable[u_diag].copy_(frozen)
            self._trips = bad.to(torch.int64) if self._trips is None \
                else self._trips + bad
        return loss.detach(), aux, gnorm
