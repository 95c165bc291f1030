from .operators import Operator, operator_definition
from .operator_impl import broadcast_to, dot, log
