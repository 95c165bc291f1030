"""Data-parallel SVI over a device mesh.

The PyTorch port of ``examples/data_parallel_svi.py``. The port runs one
process per device over ``torch.distributed``; ``DataParallelBatchLoop``
gives each rank its block of the rows, scales its data terms by the axis
size and all-reduces the loss and gradients. Run as it is, this script
starts its own process group, a world of one (NCCL on the card, gloo on
the CPU), and tears it down at the end; under a launcher that starts n
processes, call ``parallel.initialize_distributed("host:port", n, rank)``
first.
"""
import os

import numpy as np
import torch.distributed as dist

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (
    GradBasedInference, StochasticVariationalInference,
    create_Gaussian_meanfield)
from mxfusion_tpu_torch.parallel import DataParallelBatchLoop, make_mesh

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N = 1600
MAX_ITER = 30 if SMOKE else 300


def main():
    rng = np.random.default_rng(0)
    y = rng.standard_normal((N, 1)) * 2.0 + 3.0

    m = Model()
    m.mu = Normal.define_variable(mean=0., variance=100., shape=(1,))
    m.s = Variable(transformation=PositiveTransformation(),
                   initial_value=5.)
    m.y = Normal.define_variable(mean=broadcast_to(m.mu, (N, 1)),
                                 variance=broadcast_to(m.s, (N, 1)),
                                 shape=(N, 1))
    q = create_Gaussian_meanfield(model=m, observed=[m.y])
    alg = StochasticVariationalInference(num_samples=10, model=m,
                                         posterior=q, observed=[m.y])

    started = not dist.is_initialized()
    mesh = make_mesh()          # a world of one unless a group exists
    try:
        print("mesh devices: {} ({})".format(mesh.size(),
                                             dist.get_backend()))
        infr = GradBasedInference(inference_algorithm=alg,
                                  grad_loop=DataParallelBatchLoop(mesh))
        infr.run(max_iter=MAX_ITER, learning_rate=0.1, y=y)
        mu_post = infr.params[q.mu.factor.mean].flatten()[0].item()
    finally:
        if started:
            dist.destroy_process_group()
    print("posterior mean: {:.3f} (data mean {:.3f})".format(
        mu_post, y.mean()))
    return mu_post


if __name__ == "__main__":
    main()
