"""Plain PyTorch pieces of the references: products at a stated
precision, the RBF gram, softplus and Adam. Nothing here imports the
program.

``precision`` is that of the references' data-side products, those
over the rows of a batch or a request: ``"fp32"`` (IEEE float32, TF32
off: the reference), ``"tf32"`` or ``"bf16"`` (inputs rounded to
bfloat16, the product rounded to it): the controls. The products that
feed a Cholesky factor (Kuu's gram, WWᵀ) stay IEEE float32 in all three,
as the configurations pin them, and so do the factorizations and the
triangular solves: a control that fails to factor gives no number.
"""
import contextlib
import math

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32", "bf16")
LOG2PI = math.log(2.0 * math.pi)
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


@contextlib.contextmanager
def matmul_precision(name):
    """torch's float32 matmul precision ``name`` in the block, whatever
    the caller had set; restored after."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(name)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def products_at(precision):
    """The block in which a reference runs: float32 matmuls at IEEE
    float32 (a ``tf32`` product sets its own), forward and backward."""
    if precision not in PRECISIONS:
        raise ValueError("precision must be one of {}, got {!r}".format(
            PRECISIONS, precision))
    return matmul_precision("highest")


def mm(a, b, precision):
    """``a @ b`` at ``precision``; at ``bf16`` both inputs and the product
    are rounded to bfloat16 (float32 accumulation), then widened again."""
    if precision == "bf16":
        return torch.matmul(a.bfloat16(), b.bfloat16()).float()
    if precision == "tf32":
        with matmul_precision("high"):
            return torch.matmul(a, b)
    return torch.matmul(a, b)


def softplus(x):
    return F.softplus(x)


def rbf(A, B, lengthscale, variance, precision):
    """``variance · exp(-r²/2)`` of A (..., n, d) against B (..., m, d),
    both divided by the lengthscale: (..., n, m)."""
    As, Bs = A / lengthscale, B / lengthscale
    cross = mm(As, Bs.transpose(-1, -2), precision)
    r2 = torch.sum(As * As, dim=-1)[..., :, None] \
        + torch.sum(Bs * Bs, dim=-1)[..., None, :] - 2.0 * cross
    return variance * torch.exp(-0.5 * torch.clamp(r2, min=0.0))


def lower_inverse(L):
    """L⁻¹ of a lower-triangular L (..., n, n), by a triangular solve."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(
        L, torch.broadcast_to(eye, L.shape), upper=False)


def follow_steps(loss_of, state, batches, learning_rate, precision,
                 adam=None):
    """Adam (torch's defaults: betas 0.9 and 0.999, eps 1e-8 outside the
    square root) over ``loss_of(params, batch, precision)`` from
    ``state`` ({name: unconstrained tensor}), one step a batch, Adam's
    state starting from ``adam`` ({name: (first moment, second moment,
    steps taken)}; default: none taken). Returns the losses (at the
    parameters before each update), the first gradient by leaf and the
    change of each leaf after the last step."""
    b1, b2 = ADAM_BETAS
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in state.items()}
    adam = adam or {k: (torch.zeros_like(v), torch.zeros_like(v), 0)
                    for k, v in params.items()}
    m = {k: adam[k][0].detach().clone() for k in params}
    v2 = {k: adam[k][1].detach().clone() for k in params}
    taken = {k: int(adam[k][2]) for k in params}
    losses, first_grad = [], None
    with products_at(precision):
        for i, batch in enumerate(batches, 1):
            loss = loss_of(params, batch, precision)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            losses.append(float(loss.detach()))
            if first_grad is None:
                first_grad = {k: g.detach().clone() for k, g in grads.items()}
            with torch.no_grad():
                for k, p in params.items():
                    g, t = grads[k], taken[k] + i
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k] / (1 - b2 ** t)).sqrt_().add_(ADAM_EPS)
                    p.sub_(learning_rate / (1 - b1 ** t) * m[k] / denom)
            del loss, grads
    change = {k: (params[k].detach() - state[k]) for k in params}
    return losses, first_grad, change
