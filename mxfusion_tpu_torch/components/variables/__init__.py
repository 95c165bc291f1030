from .variable import Variable, VariableType
from .var_trans import (
    VariableTransformation, Softplus, PositiveTransformation, Logistic,
    SimplexTransformation)
from .runtime_variable import (
    add_sample_dimension, add_sample_dimension_to_arrays, array_has_samples,
    get_num_samples, as_samples, align_sample_arrays, arrays_as_samples,
    expectation)
