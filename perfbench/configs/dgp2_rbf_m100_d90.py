"""A two-layer deep GP (Salimbeni and Deisenroth 2017) in the port, at
the sizes of ``dgp2_rbf_m100_d90.json``: the model, its training data,
its start from a seed, and the model FLOPs of a training step."""
import json
from pathlib import Path

from ..lib.synthetic import regression_data, softplus_inverse

CONFIG = json.loads(Path(__file__).with_suffix(".json").read_text())


def widths(cfg):
    """Each layer's (input width, output width)."""
    ins = [cfg["input_dim"]] + cfg["hidden_dims"]
    return list(zip(ins, cfg["hidden_dims"] + [cfg["output_dim"]]))


def model(cfg):
    """The port's deep GP regression model, its output ``m.Y``."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.modules import DeepGPRegression
    M = cfg["num_inducing"]
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, cfg["input_dim"]))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=cfg["noise_var"])
    m.Y = DeepGPRegression.define_variable(
        X=m.X, kernels=[RBF(input_dim=d_in, ARD=cfg["ard"],
                            variance=cfg["variance"], lengthscale=ls)
                        for (d_in, _), ls in zip(widths(cfg),
                                                 cfg["lengthscales"])],
        noise_var=m.noise_var, shape=(m.n, cfg["output_dim"]),
        num_samples=cfg["num_samples"],
        inducing_inputs=[Variable(shape=(M, d_in))
                         for d_in, _ in widths(cfg)],
        jitter=cfg["jitter"], whitened=cfg["whitened"],
        inner_mean=cfg["inner_mean"])
    return m


def data(cfg, rows, generator):
    """(X, Y) of ``rows`` training rows on the generator's device."""
    return regression_data(cfg, rows, generator)


def initial_state(cfg, generator):
    """The training start, unconstrained, by name path, made on the
    generator's device: each layer's Z on the box, q(U) at the module's
    defaults (a small random mean)."""
    import torch
    M = cfg["num_inducing"]
    dev = generator.device
    state = {}
    for l, ((d_in, d_out), ls) in enumerate(zip(widths(cfg),
                                                cfg["lengthscales"])):
        state["inducing_inputs_%d" % l] = torch.rand(
            (M, d_in), generator=generator, device=dev) * cfg["box"]
        state["Y.qU_mean_%d" % l] = 0.01 * torch.randn(
            (M, d_out), generator=generator, device=dev)
        state["Y.qU_cov_W_%d" % l] = torch.eye(M, device=dev)
        state["Y.qU_cov_diag_%d" % l] = torch.full(
            (M,), softplus_inverse(1e-6), device=dev)
        state["Y.p(F_%d).rbf_lengthscale" % l] = torch.full(
            (d_in if cfg["ard"] else 1,), softplus_inverse(ls), device=dev)
        state["Y.p(F_%d).rbf_variance" % l] = torch.full(
            (1,), softplus_inverse(cfg["variance"]), device=dev)
    state["noise_var"] = torch.full((1,), softplus_inverse(cfg["noise_var"]),
                                    device=dev)
    return state


def flops_per_step(cfg, batch):
    """Model FLOPs of one training step at ``batch`` rows. Layer l at s
    samples (layer 0 at 1, the others at S), input width d, output width
    w: Kuf's cross term 2sMBd, L⁻¹Kuf sM²B (triangular), the mean
    (L⁻¹Kuf)ᵀ·μ 2sMBw, Lsᵀ·L⁻¹Kuf 2sM²B, the linear inner mean 2sBdw;
    and the M×M work (S = WWᵀ 2M³, two Cholesky factors 2M³/3, L⁻¹ M³/3);
    all three times over for the backward."""
    M, B, S = cfg["num_inducing"], batch, cfg["num_samples"]
    total = 0
    for l, (d, w) in enumerate(widths(cfg)):
        s = 1 if l == 0 else S
        total += s * (2 * M * B * d + M * M * B + 2 * M * B * w
                      + 2 * M * M * B)
        if l < len(widths(cfg)) - 1:
            total += 2 * s * B * d * w
        total += 2 * M ** 3 + 2 * M ** 3 / 3 + M ** 3 / 3
    return 3 * total


def k1_launches_per_step(cfg, batch):
    """K1's launches in one training step as (S, N, M, D, L): each layer's
    Kuu and Kuf (layer 0's at one sample, the others' at S)."""
    M, S = cfg["num_inducing"], cfg["num_samples"]
    out = []
    for l, (d, _) in enumerate(widths(cfg)):
        L = d if cfg["ard"] else 1
        out += [(1, M, M, d, L), (1 if l == 0 else S, M, batch, d, L)]
    return out
