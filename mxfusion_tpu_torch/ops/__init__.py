from .linalg import make_diagonal, broadcast_to_w_samples, cholesky_logdet
# the function, as in the JAX package; its module is reached by its full
# path (importlib.import_module("mxfusion_tpu_torch.ops.batched_cholesky"))
from .batched_cholesky import batched_cholesky
from . import cuda_build
from . import cuda_kernels
from . import precision
