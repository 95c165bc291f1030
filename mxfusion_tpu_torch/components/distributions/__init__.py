from .distribution import Distribution, UnivariateDistribution
from .random_gen import RandomGenerator, FixedRandomGenerator
from .normal import (Normal, MultivariateNormal, NormalMeanPrecision,
                     MultivariateNormalMeanPrecision)
from .pointmass import PointMass
from .gp import GaussianProcess, ConditionalGaussianProcess
from .gp import kernels as gp_kernels
