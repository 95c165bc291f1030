from .model_component import ModelComponent
from .factor import Factor
from .variables import Variable, VariableType
from . import distributions
from . import functions
from . import variables
