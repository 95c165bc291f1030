from .gp_regression import GPRegression
from .sparsegp_regression import SparseGPRegression
from .svgp_regression import SVGPRegression
from .svgp_classification import SVGPClassification
from .svgp_poisson import SVGPPoissonRegression
from .svgp_negbinom import SVGPNegBinomialRegression
from .svgp_multiclass import SVGPMultiClassification
from .lmc_svgp import LMCSVGPRegression
from .deep_gp import DeepGPClassification, DeepGPRegression
