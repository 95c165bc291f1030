from .svgp_regression import SVGPRegression
