from .function_evaluation import (
    FunctionEvaluation, FunctionEvaluationWithParameters)
from .function import Function
from .nn_function import NNFunction
from . import operators
