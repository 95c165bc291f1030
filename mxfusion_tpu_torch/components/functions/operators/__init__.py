from .operators import Operator
from .operator_impl import broadcast_to
