"""k3_roofline.train: K3's bound (``fused_bounds`` at the step's M, B and
D) over the device time of its three kernels, each launched once a step
(``mxfusion_tpu_torch/csrc/fused_gram.cu``)."""
from perfbench.lib.readers import fused_roofline

KERNELS = r"fused_bwd_de_kernel|fused_bwd_du_kernel|reduce_parts_kernel"


def read(trace, cell):
    return fused_roofline(trace, cell, KERNELS, 3, 1)
