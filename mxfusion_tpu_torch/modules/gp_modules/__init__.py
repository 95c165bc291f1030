from .gp_regression import GPRegression
from .sparsegp_regression import SparseGPRegression
from .svgp_regression import SVGPRegression
