from .distribution import Distribution, UnivariateDistribution
from .random_gen import RandomGenerator, FixedRandomGenerator
from .normal import (Normal, MultivariateNormal, NormalMeanPrecision,
                     MultivariateNormalMeanPrecision)
from .gamma import Gamma, GammaMeanVariance
from .bernoulli import Bernoulli
from .categorical import Categorical
from .beta import Beta
from .dirichlet import Dirichlet
from .pointmass import PointMass
from .exponential import Exponential
from .inverse_gamma import InverseGamma
from .lognormal import LogNormal
from .logitnormal import LogitNormal
from .stickbreaking_normal import StickBreakingNormal
from .gp import GaussianProcess, ConditionalGaussianProcess
from .gp import kernels as gp_kernels
