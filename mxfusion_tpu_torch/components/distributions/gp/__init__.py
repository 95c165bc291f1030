from .gp import GaussianProcess
from .cond_gp import ConditionalGaussianProcess
from . import kernels
