"""Model variables.

Counterpart of ``mxfusion_tpu/components/variables/variable.py``: typed
variables whose type is *derived* from the attached factor, shapes that
may contain other Variables (symbolic dimensions), constants
auto-wrapped from python/numpy scalars and arrays, and priors via
``set_prior``. Runtime values live outside the IR in a UUID-keyed
environment of tensors. The arithmetic operator sugar comes with the
operator library, which the serving path does not use.
"""
from enum import Enum

import numpy as np

from ..model_component import ModelComponent
from ...common.exceptions import ModelSpecificationError


class VariableType(Enum):
    CONSTANT = 0
    PARAMETER = 1
    RANDVAR = 2
    FUNCVAR = 3


class Variable(ModelComponent):
    """A variable in a factor graph.

    Parameters
    ----------
    value : scalar / np.ndarray / tensor, optional
        If given, the variable is a CONSTANT with this value.
    shape : tuple of int or Variable, optional
        Shape; entries may be Variables (symbolic dims bound from data at
        inference initialization). Defaults to ``(1,)``.
    transformation : VariableTransformation, optional
        Bijector from unconstrained optimizer space to the model space.
    initial_value : scalar or array, optional
        Initial value in the *model* (constrained) space.
    """

    def __init__(self, value=None, shape=None, transformation=None,
                 initial_value=None):
        super().__init__()
        self.shape = shape if shape is not None else (1,)
        # symbolic dims ride along as attributes so they migrate with us
        self.attributes = [s for s in self.shape if isinstance(s, Variable)]
        self.transformation = transformation
        if initial_value is not None and np.isscalar(initial_value):
            initial_value = np.asarray(initial_value, dtype=np.float64)
        self.initial_value = initial_value
        self._constant_value = None
        self.isInherited = False
        if value is not None:
            self._set_as_constant(value)

    # ------------------------------------------------------------------
    def _set_as_constant(self, value):
        if isinstance(value, (int, float)):
            self._constant_value = value
        else:
            self._constant_value = np.asarray(value)
            if self.shape == (1,) and self._constant_value.ndim > 0:
                self.shape = tuple(self._constant_value.shape)

    @property
    def constant(self):
        """The constant's value; raises if not a CONSTANT."""
        if self._constant_value is None:
            raise ModelSpecificationError(
                "Variable {} is not a constant.".format(self))
        return self._constant_value

    @property
    def type(self):
        """Variable type derived from the attached generating factor."""
        from ..factor import Factor
        if self._constant_value is not None:
            return VariableType.CONSTANT
        f = self.factor
        if f is None:
            return VariableType.PARAMETER
        from ..distributions.distribution import Distribution
        from ...modules.module import Module
        if isinstance(f, (Distribution, Module)):
            return VariableType.RANDVAR
        if isinstance(f, Factor):
            return VariableType.FUNCVAR
        return VariableType.PARAMETER

    @property
    def factor(self):
        """The factor that generates this variable (first predecessor)."""
        preds = self.predecessors
        return preds[0][1] if preds else None

    # ------------------------------------------------------------------
    def set_prior(self, distribution):
        """Attach ``distribution`` as the generating factor of this variable.

        Reference: variable.py:191-206.
        """
        distribution.set_outputs([self])

    def assign_factor(self, factor):
        factor.set_outputs([self])

    @property
    def initial_value_before_transformation(self):
        """Initial value mapped back to unconstrained optimizer space."""
        if self.initial_value is None:
            return None
        if self.transformation is None:
            return self.initial_value
        return self.transformation.inverse_transform(self.initial_value)

    # ------------------------------------------------------------------
    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        if attribute_map is not None:
            replica.shape = tuple(attribute_map.get(s, s) if isinstance(s, Variable)
                                  else s for s in self.shape)
        else:
            replica.shape = self.shape
        replica.transformation = self.transformation
        replica.initial_value = self.initial_value
        replica._constant_value = self._constant_value
        replica.isInherited = self.isInherited
        return replica
