"""k1_roofline.train: K1's bound (``rbf_bound`` summed over the step's
launches at the configuration's shapes) over the device time of its
kernel (``mxfusion_tpu_torch/csrc/rbf_gram.cu``)."""
from perfbench.lib.readers import rbf_roofline

KERNELS = r"rbf_gram_kernel"


def read(trace, cell):
    return rbf_roofline(trace, cell, KERNELS)
