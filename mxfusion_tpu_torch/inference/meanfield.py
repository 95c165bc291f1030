"""Gaussian mean-field posterior builder.

Counterpart of ``mxfusion_tpu/inference/meanfield.py``. The factor
family follows the latent's declared support (ADVI-style): positive
latents get a LogNormal factor, unit-interval latents a LogitNormal,
simplex latents a StickBreakingNormal, the others a Normal. All are
reparameterized transforms of a Normal, so the ELBO's gradients stay
pathwise and the Jacobian is inside the factor's own log-density.
"""
from ..models.posterior import Posterior
from ..components.variables.variable import Variable, VariableType
from ..components.variables.var_trans import PositiveTransformation
from ..components.distributions.normal import Normal
from ..components.distributions.lognormal import LogNormal
from ..components.distributions.logitnormal import LogitNormal
from ..components.distributions.stickbreaking_normal import \
    StickBreakingNormal
from ..common.exceptions import InferenceError
from ..util.inference import variables_to_UUID

_FAMILIES = {"positive": LogNormal, "unit_interval": LogitNormal,
             "simplex": StickBreakingNormal}


def create_Gaussian_meanfield(model, observed, dtype=None):
    """Attach an independent (transformed-)Normal posterior factor, with
    a positively constrained variance, to every unobserved random
    variable, its family matching the latent's support. A simplex
    latent's factor is a K-1-dimensional normal pushed through the
    stick-breaking bijector."""
    observed_uuid = set(variables_to_UUID(observed))
    q = Posterior(model)
    for v in model.variables.values():
        if v.type == VariableType.RANDVAR and v.uuid not in observed_uuid:
            sup = getattr(v.factor, "support", "real")
            param_shape = v.shape
            if sup == "simplex":
                K = v.shape[-1]
                if not isinstance(K, int):
                    raise InferenceError(
                        "Gaussian mean-field over a simplex latent "
                        "needs a concrete (non-symbolic) last event "
                        "dim; got {} for {}.".format(K, v))
                param_shape = v.shape[:-1] + (K - 1,)
            family = _FAMILIES.get(sup, Normal)
            mean = Variable(shape=param_shape)
            variance = Variable(shape=param_shape,
                                transformation=PositiveTransformation(),
                                initial_value=1.0)
            q[v].set_prior(family(mean=mean, variance=variance,
                                  dtype=dtype))
    return q
