from .distribution import Distribution, UnivariateDistribution
from .random_gen import RandomGenerator, FixedRandomGenerator
from .normal import (Normal, MultivariateNormal, NormalMeanPrecision,
                     MultivariateNormalMeanPrecision)
from .gamma import Gamma, GammaMeanVariance
from .bernoulli import Bernoulli
from .categorical import Categorical
from .beta import Beta
from .dirichlet import Dirichlet
from .wishart import Wishart
from .uniform import Uniform
from .laplace import Laplace
from .pointmass import PointMass
from .exponential import Exponential
from .inverse_gamma import InverseGamma
from .mixture import NormalMixture
from .concrete import Concrete
from .poisson import Poisson
from .studentt import StudentT
from .lognormal import LogNormal
from .logitnormal import LogitNormal
from .stickbreaking_normal import StickBreakingNormal
from .negative_binomial import NegativeBinomial
from .ssm import LinearGaussianSSM
from .ar1 import GaussianAR1
from .gp import GaussianProcess, ConditionalGaussianProcess
from .gp import kernels as gp_kernels
