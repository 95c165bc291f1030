from .function_evaluation import (
    FunctionEvaluation, FunctionEvaluationWithParameters)
from .function import Function
from . import operators
