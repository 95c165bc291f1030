"""MAP estimation.

Counterpart of ``mxfusion_tpu/inference/map.py``. An automatic posterior
places a :class:`PointMass` over every latent variable; the objective
substitutes the point-mass locations into the env and minimizes
``-log p``.
"""
from .variational import VariationalInference
from ..models.posterior import Posterior
from ..components.variables.variable import Variable, VariableType
from ..components.variables.var_trans import (PositiveTransformation,
                                              Logistic,
                                              SimplexTransformation)
from ..components.distributions.pointmass import PointMass
from ..util.inference import variables_to_UUID


class MAP(VariationalInference):
    def __init__(self, model, observed, num_samples=1):
        posterior = MAP.create_posterior(model, observed)
        super().__init__(num_samples=num_samples, model=model,
                         posterior=posterior, observed=observed)

    @staticmethod
    def create_posterior(model, observed):
        """A PointMass posterior per latent, its location constrained to
        the latent's declared support."""
        observed_uuid = set(variables_to_UUID(observed))
        q = Posterior(model)
        for v in model.variables.values():
            if v.type == VariableType.RANDVAR and \
                    v.uuid not in observed_uuid:
                sup = getattr(v.factor, "support", "real")
                if sup == "positive":
                    trans = PositiveTransformation()
                elif sup == "unit_interval":
                    trans = Logistic(0.0, 1.0)
                elif sup == "simplex":
                    trans = SimplexTransformation()
                else:
                    trans = None
                location = Variable(shape=v.shape, transformation=trans)
                q[v].set_prior(PointMass(location=location))
        return q

    def compute(self, env, ctx):
        """Substitute the locations and return ``-log p``."""
        for v in self.posterior.variables.values():
            if v.type == VariableType.RANDVAR:
                env[v.uuid] = env[v.factor.location.uuid]
        loss = -self.model.log_pdf(env, ctx=ctx)
        return loss, loss
