"""Plain reference of ``dgp2_rbf_m100_d90``: the doubly-stochastic bound
of a deep GP (Salimbeni and Deisenroth 2017), whitened, written from the
paper's equations in plain PyTorch. It imports nothing of the program.

Layer l has inducing inputs Z_l, q(v_l) = N(μ_l, S_l) over whitened
inducing values (S_l = W_lW_lᵀ + diag(d_l) = Ls_lLs_lᵀ) and
Kuu_l + jitter·mean(diag Kuu_l)·I = L_lL_lᵀ. At inputs A (s, B, d) its
marginals are, with G = L⁻¹K(Z, A),

    mean Gᵀμ + A·W_mean,  variance k(a, a) − |G|² + |Lsᵀ·G|²,

W_mean the fixed identity-like inner mean of the inner layers (none on
the last). Layer 0 runs at one sample; its draw a + sqrt(variance)·ε,
ε ~ N(0, I) of shape (S, B, width), feeds the next layer. The negative
bound is the mean over the S draws of −(N/B)·Σ_n [log N(y_n | mean_n,
σ²) − variance_n/(2σ²)] plus Σ_l KL(q(v_l) ‖ N(0, I)), a KL of
width(l) columns sharing one covariance.

The draws: the port draws each step's ε, one (S, B, width) standard
normal a hidden layer in layer order, from the generator handed to its
training run (the module's documented rule); :func:`draws` makes the
same calls on a generator seeded alike.
"""
import torch

from .common import LOG2PI, mm, rbf, softplus

VAR_FLOOR = 1e-14


def _widths(cfg):
    ins = [cfg["input_dim"]] + cfg["hidden_dims"]
    return list(zip(ins, cfg["hidden_dims"] + [cfg["output_dim"]]))


def _layer(p, l, A, cfg, precision, inner):
    """(mean (s, B, w), variance (s, B), -KL) of layer ``l`` at A."""
    Z = p["inducing_inputs_%d" % l]
    ls = softplus(p["Y.p(F_%d).rbf_lengthscale" % l])
    var = softplus(p["Y.p(F_%d).rbf_variance" % l])
    mu = p["Y.qU_mean_%d" % l]
    W = p["Y.qU_cov_W_%d" % l]
    M = Z.shape[0]
    eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
    # the products that feed a factor at IEEE float32, as the program's
    Kuu = rbf(Z, Z, ls, var, "fp32")
    Kuu = Kuu + eye * (cfg["jitter"] * torch.mean(torch.diagonal(Kuu)))
    L = torch.linalg.cholesky(Kuu)
    Ls = torch.linalg.cholesky(
        mm(W, W.T, "fp32") + torch.diag(softplus(p["Y.qU_cov_diag_%d"
                                                      % l])))
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    G = mm(Linv, rbf(Z, A, ls, var, precision), precision)    # (s, M, B)
    mean = mm(G.transpose(-1, -2), mu, precision)              # (s, B, w)
    if inner:
        d, w = A.shape[-1], mu.shape[-1]
        mean = mean + mm(A, torch.eye(d, w, dtype=A.dtype,
                                      device=A.device), precision)
    LsG = mm(Ls.T, G, precision)
    variance = var - torch.sum(G * G, dim=-2) + torch.sum(LsG * LsG, dim=-2)
    cols = mu.shape[-1]
    neg_kl = (M / 2.0 + torch.sum(torch.log(torch.diagonal(Ls)))) * cols \
        - 0.5 * torch.sum(Ls * Ls) * cols - 0.5 * torch.sum(mu * mu)
    return mean, variance, neg_kl


def loss_of(cfg, scale):
    """The negative bound of a batch (X, Y, ε) as a function of the
    parameters, the data term scaled by ``scale`` = N/B; ε holds one
    draw a hidden layer."""
    n_layers = len(_widths(cfg))

    def loss(p, batch, precision):
        X, Y, eps = batch
        A = X[None]
        neg_kl = 0.0
        for l in range(n_layers):
            mean, variance, kl = _layer(p, l, A, cfg, precision,
                                        inner=l < n_layers - 1)
            neg_kl = neg_kl + kl
            if l < n_layers - 1:
                A = mean + torch.sqrt(torch.clamp_min(
                    variance, VAR_FLOOR))[..., None] * eps[l]
        noise = softplus(p["noise_var"])
        logL = -0.5 * torch.sum((Y - mean) ** 2 / noise + LOG2PI
                                + torch.log(noise), dim=(-2, -1)) \
            - 0.5 * torch.sum(variance, dim=-1) / noise * Y.shape[-1]
        return -torch.mean(scale * logL + neg_kl)
    return loss


def draws(cfg, batch_rows, generator):
    """One step's ε: a standard normal (S, B, width) a hidden layer, in
    layer order, on ``generator``."""
    return [torch.randn((cfg["num_samples"], batch_rows, w),
                        generator=generator, device=generator.device)
            for _, w in _widths(cfg)[:-1]]
