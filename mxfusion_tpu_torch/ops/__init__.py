from .linalg import make_diagonal, broadcast_to_w_samples
from . import cuda_build
from . import cuda_kernels
from . import precision
