from .factor_graph import FactorGraph
from .model import Model
from .posterior import Posterior
