from .kernel import Kernel, NativeKernel
from .stationary import StationaryKernel
from .rbf import RBF
