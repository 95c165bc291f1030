from .distribution import Distribution, UnivariateDistribution
from .random_gen import RandomGenerator, FixedRandomGenerator
from .normal import Normal
from .gp import GaussianProcess, ConditionalGaussianProcess
from .gp import kernels as gp_kernels
