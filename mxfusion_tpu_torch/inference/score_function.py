"""Score-function (BBVI) gradient estimators.

Counterpart of ``mxfusion_tpu/inference/score_function.py`` (Ranganath
et al., Black Box Variational Inference). The loss returned for
reporting is the plain negative ELBO estimate; the loss returned for
*differentiation* is a surrogate whose gradient equals the
score-function estimator:

    ∇λ ELBO ≈ E_s[ log q_s · detach(log p_s − log q_s) ]
    ∇θ ELBO ≈ E_s[ log p_s − detach(log q_s) ]

The products are taken per Monte-Carlo sample before averaging, with
``FactorGraph.log_pdf_per_sample``. The drawn samples are detached
before they enter the env, so no pathwise term leaks in.
"""
import torch

from .variational import StochasticVariationalInference
from ..components.variables.variable import VariableType
from ..common.exceptions import InferenceError


class ScoreFunctionInference(StochasticVariationalInference):
    """BBVI without control variates; works for non-meanfield posteriors."""

    def _draw(self, env, ctx):
        samples = self.posterior.draw_samples(
            env, ctx.next_generator(), num_samples=self.num_samples)
        env.update({k: v.detach() for k, v in samples.items()})

    def compute(self, env, ctx):
        self._draw(env, ctx)
        q_z = self.posterior.log_pdf_per_sample(env)   # (s,)
        p_xz = self.model.log_pdf_per_sample(env)      # (s,)

        diff_nograd = (p_xz - q_z).detach()
        gradient_lambda = torch.mean(q_z * diff_nograd, dim=0)
        gradient_theta = torch.mean(p_xz - q_z.detach(), dim=0)
        gradient_log_L = gradient_lambda + gradient_theta

        return -gradient_theta, -gradient_log_L


class ScoreFunctionRBInference(ScoreFunctionInference):
    """Rao-Blackwellized BBVI: per-latent score terms use only the
    Markov blankets of that latent's descendants, shrinking the
    estimator's variance (requires a meanfield posterior)."""

    def compute(self, env, ctx):
        self._draw(env, ctx)
        q_z = self.posterior.log_pdf_per_sample(env)
        p_xz = self.model.log_pdf_per_sample(env)
        gradient_theta = torch.mean(p_xz - q_z.detach(), dim=0)

        posterior_rvs = [v for v in self.posterior.variables.values()
                         if v.type is VariableType.RANDVAR]
        gradient_lambda = 0.0
        for v in posterior_rvs:
            model_v = self.model[v.uuid]
            q_i = self.posterior.log_pdf_per_sample(
                env, targets=self._descendant_blanket(self.posterior, v))
            p_i = self.model.log_pdf_per_sample(
                env, targets=self._descendant_blanket(self.model, model_v))
            f_i = q_i * (p_i - q_i).detach()
            gradient_lambda = gradient_lambda + torch.mean(f_i, dim=0)

        gradient_log_L = gradient_lambda + gradient_theta
        return -gradient_theta, -gradient_log_L

    @staticmethod
    def _descendant_blanket(graph, node):
        """UUIDs of the Markov blankets of all descendants of ``node``."""
        if node.graph is not graph.components_graph:
            raise InferenceError(
                "Node {} does not belong to graph {}.".format(node, graph))
        out = set()
        for d in graph.get_descendants(node):
            out.update(m.uuid for m in graph.get_markov_blanket(d))
            out.add(d.uuid)
        return out
