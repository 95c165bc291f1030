"""SVGP regression (Hensman, Fusi and Lawrence 2013) in the port, at the
sizes of ``svgp_rbf_m1000_d8.json``: the model, its training data, its
start and served states from a seed, and the model FLOPs the bound and
the predictive moments need."""
import json
from pathlib import Path

from ..lib.synthetic import regression_data, softplus_inverse

CONFIG = json.loads(Path(__file__).with_suffix(".json").read_text())


def model(cfg):
    """The port's SVGP regression model over ``input_dim`` inputs, its
    output ``m.Y``."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.modules import SVGPRegression
    D, M = cfg["input_dim"], cfg["num_inducing"]
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=cfg["noise_var"])
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D, ARD=cfg["ard"],
                          variance=cfg["variance"],
                          lengthscale=cfg["lengthscale"]),
        noise_var=m.noise_var, shape=(m.n, cfg["output_dim"]),
        inducing_inputs=Variable(shape=(M, D)), jitter=cfg["jitter"],
        whitened=cfg["whitened"])
    return m



def lengthscales(cfg):
    """How many lengthscales the kernel has: one an input under ARD."""
    return cfg["input_dim"] if cfg["ard"] else 1


def _hyperparameters(cfg, like):
    import torch

    def raw(v, n=1):
        return torch.full((n,), softplus_inverse(v), dtype=like.dtype,
                          device=like.device)
    return {"noise_var": raw(cfg["noise_var"]),
            "Y.rbf_lengthscale": raw(cfg["lengthscale"], lengthscales(cfg)),
            "Y.rbf_variance": raw(cfg["variance"])}


def initial_state(cfg, generator):
    """The training start, unconstrained, by name path: Z on the box and
    q(U) at the module's defaults (a small random mean), made on the
    generator's device."""
    import torch
    D, M = cfg["input_dim"], cfg["num_inducing"]
    dev = generator.device
    Z = torch.rand((M, D), generator=generator, device=dev) * cfg["box"]
    return {"inducing_inputs": Z,
            "Y.qU_mean": 0.01 * torch.randn(
                (M, cfg["output_dim"]), generator=generator, device=dev),
            "Y.qU_cov_W": torch.eye(M, device=dev),
            "Y.qU_cov_diag": torch.full((M,), softplus_inverse(1e-6),
                                        device=dev),
            **_hyperparameters(cfg, Z)}


def served_state(cfg, generator):
    """A served posterior, unconstrained, by name path: Z on the box, a
    rank-8 plus 0.01·I covariance of q(U) (as ``chip_smoke.make_state``)."""
    import torch
    D, M = cfg["input_dim"], cfg["num_inducing"]
    dev = generator.device
    Z = torch.rand((M, D), generator=generator, device=dev) * cfg["box"]
    W = torch.zeros((M, M), device=dev)
    W[:, :8] = 0.1 * torch.randn((M, 8), generator=generator, device=dev)
    return {"inducing_inputs": Z,
            "Y.qU_mean": torch.randn((M, cfg["output_dim"]),
                                     generator=generator, device=dev),
            "Y.qU_cov_W": W,
            "Y.qU_cov_diag": torch.full((M,), softplus_inverse(0.01),
                                        device=dev),
            **_hyperparameters(cfg, Z)}


def data(cfg, rows, generator):
    """(X, Y) of ``rows`` training rows on the generator's device."""
    return regression_data(cfg, rows, generator)


def flops_per_step(cfg, batch):
    """Model FLOPs of one training step at ``batch`` rows: the bound's
    products over the batch (Kuf's cross term 2MBD, G = L⁻¹Kuf M²B
    (triangular), Gᵀ·L⁻¹Ls 2M²B, Gᵀ·L⁻¹μ 2MB), twice again for their
    backward, and the M×M work (S = WWᵀ 2M³, two Cholesky factors 2M³/3,
    L⁻¹ M³/3, L⁻¹Ls and L⁻¹μ) three times over."""
    M, D, B = cfg["num_inducing"], cfg["input_dim"], batch
    per_batch = 2 * M * B * D + M * M * B + 2 * M * M * B + 2 * M * B
    per_m = 2 * M ** 3 + 2 * M ** 3 / 3 + M ** 3 / 3 + M ** 3 + M * M
    return 3 * (per_batch + per_m)


def flops_per_row(cfg):
    """Model FLOPs of the predictive mean and variance of one row: Kxz's
    cross term 2MD, L⁻¹Kzx M² (triangular), (L⁻¹SL⁻ᵀ)·L⁻¹Kzx 2M², the
    mean 2M and the variance's sums 4M. The M×M work, which a served
    posterior needs once, is not counted."""
    M, D = cfg["num_inducing"], cfg["input_dim"]
    return 2 * M * D + 3 * M * M + 6 * M


def k1_launches_per_step(cfg, batch):
    """K1's launches in one training step as (S, N, M, D, L): Kuu (the
    fused arm builds no Kuf)."""
    M, D = cfg["num_inducing"], cfg["input_dim"]
    return [(1, M, M, D, lengthscales(cfg))]


def k1_launches_per_chunk(cfg, chunk):
    """K1's launches in one served chunk: Kuu and Kzx."""
    M, D, L = cfg["num_inducing"], cfg["input_dim"], lengthscales(cfg)
    return [(1, M, M, D, L), (1, M, chunk, D, L)]
