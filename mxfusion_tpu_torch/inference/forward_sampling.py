"""Forward (ancestral) sampling.

Counterpart of ``mxfusion_tpu/inference/forward_sampling.py``.
``merge_posterior_into_model`` grafts trained posterior factors over the
model's priors via clone + extract_distribution_of + replace_subgraph.
"""
from .inference import TransferInference
from .inference_alg import SamplingAlgorithm
from .variational import StochasticVariationalInference
from .map import MAP
from ..components.variables.variable import Variable
from ..common.exceptions import InferenceError


class ForwardSamplingAlgorithm(SamplingAlgorithm):
    """Ancestral sampling over the model graph."""

    def compute(self, env, ctx):
        return self.model.draw_samples(
            env, ctx.next_generator(), num_samples=self.num_samples,
            targets=self.target_variables)


class ForwardSampling(TransferInference):
    """Forward sampling warm-started with previous inference parameters."""

    def __init__(self, num_samples, model, observed, infr_params,
                 var_tie=None, target_variables=None, constants=None,
                 dtype=None):
        if target_variables is not None:
            target_variables = [v.uuid for v in target_variables
                                if isinstance(v, Variable)]
        algorithm = ForwardSamplingAlgorithm(
            model=model, observed=observed, num_samples=num_samples,
            target_variables=target_variables)
        super().__init__(inference_algorithm=algorithm,
                         infr_params=infr_params, constants=constants,
                         dtype=dtype)
        if var_tie:
            model._var_ties.update(
                {k.uuid if hasattr(k, "uuid") else k:
                 v.uuid if hasattr(v, "uuid") else v
                 for k, v in var_tie.items()})


def merge_posterior_into_model(model, posterior, observed):
    """Replace each latent's prior with its trained posterior factor."""
    new_model = model.clone()
    for lv in model.get_latent_variables(
            [v.uuid if hasattr(v, "uuid") else v for v in observed]):
        v = posterior.extract_distribution_of(posterior[lv])
        new_model.replace_subgraph(new_model[v.uuid], v)
    return new_model


class VariationalPosteriorForwardSampling(ForwardSampling):
    """Sample the model with priors swapped for the trained posterior."""

    def __init__(self, num_samples, observed, inherited_inference,
                 target_variables=None, constants=None, dtype=None):
        if not isinstance(inherited_inference.inference_algorithm,
                          (StochasticVariationalInference, MAP)):
            raise InferenceError(
                "inherited_inference must carry a variational or MAP "
                "algorithm.")
        m = inherited_inference.inference_algorithm.model
        q = inherited_inference.inference_algorithm.posterior
        model_graph = merge_posterior_into_model(
            m, q, observed=inherited_inference.observed_variables)
        super().__init__(
            num_samples=num_samples, model=model_graph, observed=observed,
            infr_params=inherited_inference.params,
            target_variables=target_variables, constants=constants,
            dtype=dtype)
