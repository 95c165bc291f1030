"""Plain reference of ``svgp_rbf_m1000_d8``: the uncollapsed SVGP bound
of Hensman, Fusi and Lawrence (2013), standard parameterization, and
its predictive moments, written from the paper's equations in plain
PyTorch. It imports nothing of the program.

With Kuu = K(Z, Z) + jitter·I = LLᵀ, S = WWᵀ + diag(d) = LsLsᵀ and
G = L⁻¹K(Z, X), the negative bound over a batch of B of N rows is

    −(N/B)·Σ_n [log N(y_n | Gᵀ_n L⁻¹μ, σ²) − (k_nn − |G_n|²)/(2σ²)
                − |L⁻¹Ls · G_n|²/(2σ²)] + KL(q(U) ‖ p(U))

with KL = −M/2 − Σ log diag(Ls) + Σ log diag(L) + |L⁻¹Ls|²/2 +
|L⁻¹μ|²/2 (one output column).
"""
import torch

from .common import LOG2PI, lower_inverse, mm, rbf, softplus


def _hyper(p):
    return (softplus(p["Y.rbf_lengthscale"]), softplus(p["Y.rbf_variance"]),
            softplus(p["noise_var"]))


def _factors(p, cfg):
    """L, Ls, L⁻¹, L⁻¹Ls and L⁻¹μ of the parameters ``p``, at IEEE
    float32 (the M×M work is not data-side)."""
    Z = p["inducing_inputs"]
    ls, var, _ = _hyper(p)
    M = Z.shape[0]
    eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
    # the products that feed a factor at IEEE float32, as the program's
    Kuu = rbf(Z, Z, ls, var, "fp32") + cfg["jitter"] * eye
    W = p["Y.qU_cov_W"]
    S = mm(W, W.T, "fp32") + torch.diag(softplus(p["Y.qU_cov_diag"]))
    L = torch.linalg.cholesky(Kuu)
    Ls = torch.linalg.cholesky(S)
    Linv = lower_inverse(L)
    return L, Ls, Linv, mm(Linv, Ls, "fp32"), \
        mm(Linv, p["Y.qU_mean"], "fp32")


def loss_of(cfg, scale):
    """The negative bound of a batch (X, Y, _) as a function of the
    parameters, the data term scaled by ``scale`` = N/B."""
    def loss(p, batch, precision):
        X, Y, _ = batch
        ls, var, noise = _hyper(p)
        L, Ls, Linv, LinvLs, Linvmu = _factors(p, cfg)
        M = L.shape[0]
        G = mm(Linv, rbf(p["inducing_inputs"], X, ls, var, precision),
               precision)                                        # (M, B)
        f = mm(G.T, Linvmu, precision)                           # (B, 1)
        GLs = mm(G.T, LinvLs, precision)                         # (B, M)
        qff = torch.sum(G * G, dim=0)
        logL = -0.5 * torch.sum((Y - f) ** 2 / noise + LOG2PI
                                + torch.log(noise)) \
            - 0.5 * torch.sum(var - qff) / noise \
            - 0.5 * torch.sum(GLs * GLs) / noise
        kl = -M / 2.0 - torch.sum(torch.log(torch.diagonal(Ls))) \
            + torch.sum(torch.log(torch.diagonal(L))) \
            + 0.5 * torch.sum(LinvLs * LinvLs) \
            + 0.5 * torch.sum(Linvmu * Linvmu)
        return -(scale * logL) + kl
    return loss


def draws(cfg, batch_rows, generator):
    """The bound draws nothing."""
    return None


def moments(p, X, cfg, precision, block=65536):
    """Predictive mean and noise-free diagonal variance at X (n, D), in
    blocks of ``block`` rows: mean (L⁻¹Kzx)ᵀ·L⁻¹μ, variance k_xx −
    |L⁻¹Kzx|² + |(L⁻¹Ls)ᵀ·L⁻¹Kzx|², column by column."""
    ls, var, _ = _hyper(p)
    with torch.no_grad():
        L, Ls, Linv, LinvLs, Linvmu = _factors(p, cfg)
        means, variances = [], []
        for lo in range(0, X.shape[0], block):
            A = mm(Linv, rbf(p["inducing_inputs"], X[lo:lo + block], ls,
                             var, precision), precision)          # (M, b)
            means.append(mm(A.T, Linvmu, precision))
            B = mm(LinvLs.T, A, precision)
            variances.append((var - torch.sum(A * A, dim=0)
                              + torch.sum(B * B, dim=0))[:, None])
        return torch.cat(means), torch.cat(variances)
