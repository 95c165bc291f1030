"""k1_roofline.serve: K1's bound (``rbf_bound`` over each chunk's Kuu and
Kzx) over the device time of its kernel
(``mxfusion_tpu_torch/csrc/rbf_gram.cu``)."""
from perfbench.lib.readers import rbf_roofline

KERNELS = r"rbf_gram_kernel"


def read(trace, cell):
    return rbf_roofline(trace, cell, KERNELS)
