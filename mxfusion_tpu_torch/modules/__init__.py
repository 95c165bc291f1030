from .module import Module
from .gp_modules import SVGPRegression
