from .kernel import Kernel, NativeKernel, CombinationKernel
from .stationary import StationaryKernel
from .rbf import RBF
from .matern import Matern, Matern12, Matern32, Matern52
from .linear import Linear
from .static import Bias, White
from .extra import RationalQuadratic, Periodic, Polynomial
from .add_kernel import AddKernel
from .multiply_kernel import MultiplyKernel
