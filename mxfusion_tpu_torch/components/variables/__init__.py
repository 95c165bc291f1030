from .variable import Variable, VariableType
from .var_trans import (
    VariableTransformation, Softplus, PositiveTransformation, Logistic,
    SimplexTransformation)
from .runtime_variable import (
    as_samples, align_sample_arrays, arrays_as_samples, expectation)
