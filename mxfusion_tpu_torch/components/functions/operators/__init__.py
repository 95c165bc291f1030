from .operators import Operator, operator_definition
from .operator_impl import (add, subtract, multiply, divide, power, square,
                            exp, sigmoid, tanh, softplus, probit, log,
                            broadcast_to, dot)
