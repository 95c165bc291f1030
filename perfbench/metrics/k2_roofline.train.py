"""k2_roofline.train: K2's bound (``fused_bounds`` at the step's M, B and
D) over the device time of its kernel, one launch a step
(``mxfusion_tpu_torch/csrc/fused_gram.cu``)."""
from perfbench.lib.readers import fused_roofline

KERNELS = r"fused_fwd_kernel"


def read(trace, cell):
    return fused_roofline(trace, cell, KERNELS, 1, 0)
