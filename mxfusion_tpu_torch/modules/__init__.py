from .module import Module
from .gp_modules import (GPRegression, SparseGPRegression,
                         SVGPRegression, SVGPClassification,
                         SVGPMultiClassification, LMCSVGPRegression,
                         SVGPPoissonRegression,
                         SVGPNegBinomialRegression, DeepGPRegression,
                         DeepGPClassification)
