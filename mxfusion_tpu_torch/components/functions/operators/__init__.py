from .operators import Operator, operator_definition
from .operator_impl import (add, subtract, multiply, divide, power, square,
                            exp, sigmoid, tanh, softplus, probit, log, sum,
                            mean, prod, dot, diag, reshape, transpose,
                            broadcast_to)
