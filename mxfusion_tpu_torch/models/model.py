"""Model: a FactorGraph for the generative model.

Counterpart of ``mxfusion_tpu/models/model.py``.
"""
from .factor_graph import FactorGraph


class Model(FactorGraph):
    def __init__(self, name="Model", verbose=False):
        super().__init__(name=name, verbose=verbose)

    def clone(self, leaves=None):
        return super().clone(leaves=leaves)
