"""linalg_ms_per_chunk.serve: device time of the Cholesky and triangular
solve kernels per served chunk (the prediction refactors Kuu and S and
solves against Kzx in every chunk)."""
from perfbench.lib.readers import kernel_ms_per

KERNELS = r"potrf|trsm|trsv|cholesky"


def read(trace, cell):
    return kernel_ms_per(trace, KERNELS, "chunks")
