"""Module-aware prediction.

Counterpart of ``mxfusion_tpu/inference/prediction.py``. Walks the graph
topologically, evaluating functions, sampling distributions, and calling
``predict`` on modules (which dispatches to their attached closed-form
prediction algorithms).
"""
from .inference_alg import SamplingAlgorithm
from ..components.distributions.distribution import Distribution
from ..components.functions.function_evaluation import FunctionEvaluation
from ..common.exceptions import InferenceError


class ModulePredictionAlgorithm(SamplingAlgorithm):
    def compute(self, env, ctx):
        from ..modules.module import Module
        outcomes = {}
        for f in self.model.ordered_factors:
            if isinstance(f, Module):
                outcome_uuid = [v.uuid for _, v in f.outputs]
                # pass the RAW request through (None = caller never
                # chose a count), so module algorithms with their own
                # default can tell "unset" from an explicit 1
                outcome = f.predict(env, ctx.next_generator(),
                                    targets=outcome_uuid,
                                    num_samples=self.num_samples_requested)
                for v, uuid in zip(outcome, outcome_uuid):
                    env[uuid] = v
                    outcomes[uuid] = v
            elif isinstance(f, FunctionEvaluation):
                results = f.eval(env)
                for name, var in f.outputs:
                    env[var.uuid] = results[name]
                    outcomes[var.uuid] = results[name]
            elif isinstance(f, Distribution):
                known = [v.uuid in env for _, v in f.outputs]
                if all(known):
                    continue
                if any(known):
                    raise InferenceError(
                        "Part of the outputs of {} is observed.".format(
                            type(f).__name__))
                outcome = f.draw_samples(env, ctx.next_generator(),
                                         num_samples=self.num_samples)
                outcome = outcome if isinstance(outcome, (tuple, list)) \
                    else (outcome,)
                for (name, var), v in zip(f.outputs, outcome):
                    env[var.uuid] = v
                    outcomes[var.uuid] = v
        if self.target_variables:
            return tuple(outcomes[uuid] for uuid in self.target_variables)
        return outcomes
