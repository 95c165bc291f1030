"""Laplace approximation around a MAP fit.

Counterpart of ``mxfusion_tpu/inference/laplace.py``. Given a trained
MAP inference, this computes the Gaussian posterior approximation

    q(θ) = N(θ̂, H⁻¹),   H = ∇²_θ [-log p(y, θ)] at θ = θ̂

over ALL latent variables jointly (cross-variable covariance blocks
included), plus the Laplace estimate of the log model evidence

    log p(y) ≈ log p(y, θ̂) + (d/2) log 2π - ½ log |H|.

The Hessian is reverse over reverse: one ``torch.autograd.grad`` with
``create_graph=True``, then one ``autograd.grad`` of the gradient per
row of H. Every custom ``autograd.Function`` on a model's path has a
backward built from differentiable operations, so the second pass runs
through them: K1's (the RBF gram, ``ops/cuda_kernels.py``) recomputes
through its plain version, so on the card the forward is K1 and the
second-order terms are plain torch. The fused gram (K2/K3) is not
differentiable twice and is switched off for the pass, as the JAX
package switches its Pallas op off around ``jax.hessian``.

Intended scale: d (total latent dimension) up to a few thousand; the
d x d Hessian is materialized.
"""
import math

import numpy as np
import torch

from .inference_alg import create_executor, RuntimeContext, VariableEnv
from ..common.exceptions import InferenceError
from ..components.variables.variable import VariableType
from ..ops import fused_gram, precision


class LaplaceResult:
    """Joint Gaussian approximation over the latents.

    Attributes
    ----------
    uuids : list of latent variable uuids (block order)
    shapes : {uuid: event shape}
    mean : {uuid: MAP value (a tensor on the run's device)}
    cov : (d, d) joint covariance tensor, blocks in ``uuids`` order
          (row-major flattened per variable)
    log_evidence : float, Laplace estimate of log p(y)
    """

    def __init__(self, uuids, shapes, mean, cov, log_evidence):
        self.uuids = uuids
        self.shapes = shapes
        self.mean = mean
        self.cov = cov
        self.log_evidence = log_evidence

    def marginal(self, variable):
        """(mean, cov) of one latent's marginal block."""
        u = variable.uuid if hasattr(variable, "uuid") else variable
        i = self.uuids.index(u)
        start = sum(int(np.prod(self.shapes[v], dtype=np.int64))
                    for v in self.uuids[:i])
        d = int(np.prod(self.shapes[u], dtype=np.int64))
        return (self.mean[u],
                self.cov[start:start + d, start:start + d])


def _hessian(fn, flat):
    """``fn(flat)`` (detached) and its Hessian in ``flat``: the gradient
    with its graph kept, then one backward of the gradient per row."""
    with torch.enable_grad():
        x = flat.detach().requires_grad_(True)
        value = fn(x)
        (g,) = torch.autograd.grad(value, x, create_graph=True)
        rows = []
        for i in range(x.shape[0]):
            (row,) = torch.autograd.grad(g[i], x, retain_graph=True,
                                         allow_unused=True)
            rows.append(torch.zeros_like(x) if row is None else row)
    return value.detach(), torch.stack(rows).detach()


def laplace_approximation(map_inference, generator=None, **data):
    """Laplace-approximate the posterior of a trained MAP inference.

    Parameters
    ----------
    map_inference : GradBasedInference over a MAP algorithm, already run
        (or initialized with its locations set)
    generator : ``torch.Generator`` for a model that draws (default:
        seeded with 0 on the store's device)
    data : the observed data (same kwargs as ``run``)
    """
    alg = map_inference._algorithm
    posterior = getattr(alg, "posterior", None)
    if posterior is None:
        raise InferenceError("laplace_approximation needs a MAP "
                             "inference (PointMass posterior).")
    params = map_inference.params
    if generator is None:
        generator = torch.Generator(device=params.device).manual_seed(0)

    # latent -> PointMass location mapping (posterior shares uuids)
    latent_loc = {}
    for v in posterior.variables.values():
        if v.type == VariableType.RANDVAR and v.factor is not None \
                and type(v.factor).__name__ == "PointMass":
            latent_loc[v.uuid] = v.factor.location
    if not latent_loc:
        raise InferenceError("MAP posterior holds no PointMass latents.")

    executor = create_executor(alg, params)
    data_list = [data[n] for n in alg.observed_variable_names]
    with torch.no_grad():
        base_env = executor.build_env(params.trainable_params(),
                                      params.fixed_params(), data_list)

    uuids = sorted(latent_loc)
    mean = {u: params[latent_loc[u]].detach() for u in uuids}
    shapes = {u: tuple(mean[u].shape) for u in uuids}
    sizes = [int(np.prod(shapes[u], dtype=np.int64)) for u in uuids]
    d = sum(sizes)

    def neg_logp(flat):
        # VariableEnv, not dict: module algorithms resolve Variable keys
        env = VariableEnv(base_env)
        off = 0
        for u, sz in zip(uuids, sizes):
            # leading sample axis of size 1, as the runtime convention
            env[u] = flat[off:off + sz].reshape((1,) + shapes[u])
            off += sz
        return -alg.model.log_pdf(env, ctx=RuntimeContext(generator))

    flat0 = torch.cat([mean[u].reshape(-1) for u in uuids])
    # K3 is not differentiable twice: materialize Kuf for the pass. The
    # second-order products run outside every tiered product's pinned
    # scope, so IEEE fp32 is pinned over the whole pass (and every data
    # tier with it) rather than left at the process's matmul precision
    with fused_gram.disabled(), precision.data_precision_scope("highest"), \
            precision._matmul_precision("highest"):
        nlp0, H = _hessian(neg_logp, flat0)
    H = 0.5 * (H + H.T)
    L, info = torch.linalg.cholesky_ex(H)
    if bool(info != 0) or bool(torch.any(torch.isnan(L))):
        raise InferenceError(
            "Hessian at the MAP point is not positive definite — the "
            "fit has not converged to a mode (or the mode is "
            "degenerate); run MAP longer.")
    cov = torch.cholesky_solve(
        torch.eye(d, dtype=H.dtype, device=H.device), L)
    logdet_H = 2.0 * float(torch.sum(torch.log(torch.diagonal(L))))
    log_evidence = (-float(nlp0) + 0.5 * d * math.log(2.0 * math.pi)
                    - 0.5 * logdet_H)
    return LaplaceResult(uuids, shapes, mean, cov, log_evidence)
