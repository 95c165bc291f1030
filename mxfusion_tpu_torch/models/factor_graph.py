"""FactorGraph: the model IR container.

Counterpart of ``mxfusion_tpu/models/factor_graph.py``. A
``networkx.MultiDiGraph`` holds Variables and Factors with named edges;
``__setattr__`` attaches and names components. The runtime interpreters
(``log_pdf``/``draw_samples``) walk factors in topological order against
a UUID-keyed env of tensors.

Graph surgery (remove/replace subgraph, extract_distribution_of),
cloning with UUID preservation and Markov blankets are here; the JSON
skeletons and graph reconciliation come with save/load.
"""
import networkx as nx
import torch

from ..components.model_component import ModelComponent
from ..components.factor import Factor
from ..components.variables.variable import Variable, VariableType
from ..components.distributions.distribution import Distribution
from ..components.functions.function_evaluation import FunctionEvaluation
from ..common.exceptions import ModelSpecificationError, InferenceError


def _sum_event_dims(lp):
    """(s, ...) -> (s,). ``torch.sum`` over an empty dim tuple would sum
    everything, so an (s,) term (a module's bound) is returned as is."""
    return torch.sum(lp, dim=tuple(range(1, lp.ndim))) if lp.ndim > 1 \
        else lp


class FactorGraph:
    """Container of a directed factor graph."""

    def __init__(self, name=None, verbose=False):
        # bypass our own __setattr__ for internals
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "_verbose", verbose)
        object.__setattr__(self, "components_graph", nx.MultiDiGraph())
        object.__setattr__(self, "_var_ties", {})

    # ------------------------------------------------------------------
    # attachment & views
    # ------------------------------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, ModelComponent):
            value.name = name
            value.graph = self.components_graph
            if self._verbose:
                print("Attached {} as {}.".format(value, name))
        object.__setattr__(self, name, value)

    def __getitem__(self, uuid):
        return self.components[uuid]

    @property
    def components(self):
        return {c.uuid: c for c in self.components_graph.nodes}

    @property
    def variables(self):
        return {c.uuid: c for c in self.components_graph.nodes
                if isinstance(c, Variable)}

    @property
    def factors(self):
        return {c.uuid: c for c in self.components_graph.nodes
                if isinstance(c, Factor)}

    @property
    def distributions(self):
        return {c.uuid: c for c in self.components_graph.nodes
                if isinstance(c, Distribution)}

    @property
    def functions(self):
        return {c.uuid: c for c in self.components_graph.nodes
                if isinstance(c, FunctionEvaluation)}

    @property
    def modules(self):
        from ..modules.module import Module
        return {c.uuid: c for c in self.components_graph.nodes
                if isinstance(c, Module)}

    @property
    def ordered_factors(self):
        """Factors in topological order."""
        return [c for c in nx.topological_sort(self.components_graph)
                if isinstance(c, Factor)]

    @property
    def roots(self):
        return [c for c in self.components_graph.nodes
                if self.components_graph.in_degree(c) == 0]

    @property
    def leaves(self):
        return [c for c in self.components_graph.nodes
                if self.components_graph.out_degree(c) == 0]

    @property
    def var_ties(self):
        return self._var_ties

    def tie_variables(self, tied, to):
        """Alias ``tied`` to ``to`` at runtime: the env entry of ``tied``
        is replaced by ``to``'s value when the executor builds the env."""
        self._var_ties[tied.uuid if hasattr(tied, "uuid") else tied] = \
            to.uuid if hasattr(to, "uuid") else to

    def __repr__(self):
        lines = ["{}({})".format(type(self).__name__, self.name or "")]
        for f in self.ordered_factors:
            outs = ", ".join(v.name or v.uuid[:6] for _, v in f.outputs)
            ins = ", ".join("{}={}".format(n, v.name or v.uuid[:6])
                            for n, v in f.inputs)
            lines.append("  {} ~ {}({})".format(outs, type(f).__name__, ins))
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # runtime interpreters
    # ------------------------------------------------------------------
    def log_pdf_terms(self, env, targets=None, ctx=None):
        """Per-factor log-density terms, each reduced to shape ``(s,)``
        (summed over event dims, sample axis kept).

        ``env``: {uuid: tensor with leading sample axis}. Function
        evaluations write their outputs into the env; distributions and
        modules contribute terms.
        """
        from ..modules.module import Module
        if targets is not None:
            targets = set(t.uuid if hasattr(t, "uuid") else t
                          for t in targets)
        terms = []
        for f in self.ordered_factors:
            if isinstance(f, Module):
                if targets is None:
                    module_targets = [v.uuid for _, v in f.outputs
                                      if v.uuid in env]
                else:
                    module_targets = [v.uuid for _, v in f.outputs
                                      if v.uuid in targets]
                if module_targets:
                    lp = f.log_pdf(env, targets=module_targets, ctx=ctx)
                    terms.append(_sum_event_dims(lp))
            elif isinstance(f, FunctionEvaluation):
                results = f.eval(env)
                for name, var in f.outputs:
                    env[var.uuid] = results[name]
            elif isinstance(f, Distribution):
                if targets is None or f.random_variable.uuid in targets:
                    lp = f.log_pdf(env)
                    terms.append(_sum_event_dims(lp))
            else:
                raise ModelSpecificationError(
                    "Non-factor {} in ordered_factors.".format(f))
        return terms

    def log_pdf(self, env, targets=None, ctx=None):
        """Σ_factors mean_samples(term)."""
        terms = self.log_pdf_terms(env, targets=targets, ctx=ctx)
        logL = 0.0
        for t in terms:
            logL = logL + torch.mean(t, dim=0)
        return logL

    def log_pdf_per_sample(self, env, targets=None, ctx=None):
        """Per-sample joint log density, shape ``(num_samples,)``.

        Terms with a size-1 sample axis broadcast against sampled terms;
        an empty target set gives ``zeros((1,))`` on the env's device.
        The score-function estimators need the per-sample values before
        the Monte-Carlo average.
        """
        terms = self.log_pdf_terms(env, targets=targets, ctx=ctx)
        if not terms:
            like = next((v for v in env.values()
                         if isinstance(v, torch.Tensor)), None)
            return torch.zeros((1,), device=None if like is None
                               else like.device)
        out = terms[0]
        for t in terms[1:]:
            out = out + t
        return out

    def draw_samples(self, env, generator, num_samples=1, targets=None):
        """Ancestral sampling with one ``torch.Generator``.

        Observed variables (already in env) are skipped; partially
        observed factors raise. Returns {uuid: samples} or a tuple in
        ``targets`` order.
        """
        from ..modules.module import Module
        samples = {}
        for f in self.ordered_factors:
            if isinstance(f, Module):
                outcome_uuid = [v.uuid for _, v in f.outputs]
                known = [u in env for u in outcome_uuid]
                if all(known):
                    continue          # observed, like Distribution below
                if any(known):
                    raise InferenceError(
                        "Part of the outputs of {} is observed.".format(
                            type(f).__name__))
                outcome = f.draw_samples(env, generator,
                                         num_samples=num_samples,
                                         targets=outcome_uuid)
                for v, uuid in zip(outcome, outcome_uuid):
                    env[uuid] = v
                    samples[uuid] = v
            elif isinstance(f, FunctionEvaluation):
                results = f.eval(env)
                for name, var in f.outputs:
                    env[var.uuid] = results[name]
                    samples[var.uuid] = results[name]
            elif isinstance(f, Distribution):
                known = [v.uuid in env for _, v in f.outputs]
                if all(known):
                    continue
                if any(known):
                    raise InferenceError(
                        "Part of the outputs of {} is observed.".format(
                            type(f).__name__))
                outcome = f.draw_samples(env, generator,
                                         num_samples=num_samples)
                outcome = outcome if isinstance(outcome, (tuple, list)) \
                    else (outcome,)
                for (name, var), v in zip(f.outputs, outcome):
                    env[var.uuid] = v
                    samples[var.uuid] = v
            else:
                raise ModelSpecificationError(
                    "Non-factor {} in ordered_factors.".format(f))
        if targets:
            return tuple(samples[uuid] for uuid in targets)
        return samples

    # ------------------------------------------------------------------
    # graph surgery
    # ------------------------------------------------------------------
    def remove_component(self, component):
        """Detach a component from the graph."""
        g = self.components_graph
        if component not in g:
            raise ModelSpecificationError(
                "{} is not in graph {}.".format(component, self.name))
        g.remove_node(component)
        component._parent_graph = None
        if component.name is not None and \
                getattr(self, component.name, None) is component:
            object.__delattr__(self, component.name)

    def remove_subgraph(self, component):
        """Remove a factor/variable and its ancestors feeding only into it."""
        pending = [component]
        while pending:
            node = pending.pop()
            if node not in self.components_graph:
                continue
            preds = [p for _, p in node.predecessors]
            self.remove_component(node)
            for p in preds:
                if self.components_graph.out_degree(p) == 0:
                    pending.append(p)

    def replace_subgraph(self, target_variable, new_subgraph_variable):
        """Replace the generating subgraph of ``target_variable`` with the
        factor generating ``new_subgraph_variable``."""
        old_factor = target_variable.factor
        if old_factor is not None:
            self.remove_subgraph(old_factor)
        new_factor = new_subgraph_variable.factor
        if new_factor is None:
            raise ModelSpecificationError(
                "The replacement variable has no generating factor.")
        # detach replacement factor from its placeholder output and rewire
        new_factor.set_outputs([target_variable])

    def extract_distribution_of(self, variable):
        """Replicate the generating distribution of ``variable`` with its
        full parent subgraph, detached from everything downstream."""
        from ..components.factor import Factor as _Factor

        def policy(component):
            if isinstance(component, _Factor):
                return ("recursive", "one_level")
            return ("recursive", None)

        return variable.replicate(replication_function=policy)

    def clone(self, leaves=None):
        """Clone the whole graph preserving UUIDs."""
        new_graph = type(self)(name=self.name)
        var_map = {}
        targets = leaves if leaves is not None else self.leaves
        replicas = []
        for leaf in targets:
            replicas.append(leaf.replicate(
                var_map=var_map,
                replication_function=lambda c: ("recursive", "recursive")))
        for r in replicas:
            r.graph = new_graph.components_graph
        # restore named attribute access
        for comp in new_graph.components_graph.nodes:
            if comp.name is not None:
                object.__setattr__(new_graph, comp.name, comp)
        return new_graph

    # ------------------------------------------------------------------
    # structure queries
    # ------------------------------------------------------------------
    def get_markov_blanket(self, node):
        """Parents ∪ children ∪ co-parents of a variable."""
        parents = set()
        children = set()
        coparents = set()
        for _, f in node.predecessors:
            for _, p in f.predecessors:
                parents.add(p)
        for _, f in node.successors:
            for _, c in f.successors:
                children.add(c)
            for _, cp in f.predecessors:
                if cp is not node:
                    coparents.add(cp)
        return parents | children | coparents

    def get_descendants(self, node):
        """All variables reachable downstream of ``node`` (incl. node)."""
        out = set()
        pending = [node]
        while pending:
            n = pending.pop()
            if n in out:
                continue
            if isinstance(n, Variable):
                out.add(n)
            pending.extend(s for _, s in n.successors)
        return out

    def get_parameters(self, excluded=None, include_inherited=True):
        """All PARAMETER variables."""
        excluded = set(excluded) if excluded else set()
        return [v for v in self.variables.values()
                if v.type == VariableType.PARAMETER
                and v.uuid not in excluded
                and (include_inherited or not v.isInherited)]

    def get_constants(self):
        """All CONSTANT variables."""
        return [v for v in self.variables.values()
                if v.type == VariableType.CONSTANT]

    def get_latent_variables(self, observed):
        observed = set(observed)
        return [v for v in self.variables.values()
                if v.type == VariableType.RANDVAR and v.uuid not in observed]
