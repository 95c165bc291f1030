"""FactorGraph: the model IR container.

Counterpart of ``mxfusion_tpu/models/factor_graph.py``. A
``networkx.MultiDiGraph`` holds Variables and Factors with named edges;
``__setattr__`` attaches and names components. The runtime interpreters
(``log_pdf``/``draw_samples``) walk factors in topological order against
a UUID-keyed env of tensors.

Graph surgery (remove/replace subgraph, extract_distribution_of),
cloning with UUID preservation, Markov blankets, and the JSON skeletons
with the name+topology graph reconciliation that save/load matches a
loaded zip by are here.
"""
import warnings

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

    # ------------------------------------------------------------------
    # serialization & reconciliation
    # ------------------------------------------------------------------
    def as_json(self):
        """Skeleton: nodes (uuid/name/type) + labeled edges, in the JAX
        package's layout."""
        from ..modules.module import Module
        nodes = []
        for c in self.components_graph.nodes:
            j = c.as_json()
            if isinstance(c, Module):
                j["module_graphs"] = c.internal_graphs_as_json()
            nodes.append(j)
        edges = [{"source": u.uuid, "target": v.uuid, "label": k}
                 for u, v, k in self.components_graph.edges(keys=True)]
        return {"name": self.name, "nodes": nodes, "edges": edges}

    @staticmethod
    def load_graphs_json(graphs_list):
        """Rebuild skeleton graphs from JSON (bare ModelComponents)."""
        out = []
        for gj in graphs_list:
            sk = FactorGraph(name=gj.get("name"))
            by_uuid = {}
            for nj in gj["nodes"]:
                c = ModelComponent()
                c._uuid = nj["uuid"]
                c.name = nj.get("name")
                c._skeleton_type = nj.get("type")
                c._module_graphs_json = nj.get("module_graphs")
                c._parent_graph = sk.components_graph
                sk.components_graph.add_node(c)
                by_uuid[c.uuid] = c
            for ej in gj["edges"]:
                sk.components_graph.add_edge(
                    by_uuid[ej["source"]], by_uuid[ej["target"]],
                    key=ej["label"])
            out.append(sk)
        return out

    @staticmethod
    def reconcile_graphs(current_graphs, primary_previous_graph,
                         secondary_previous_graphs=None):
        """Match loaded skeletons onto freshly built graphs.

        Returns ``{previous_uuid: current_uuid}``. Seeds are components
        with equal names and nodes an earlier graph already matched;
        matching expands by BFS over identically labeled edges in both
        directions.
        """
        previous_graphs = [primary_previous_graph] + \
            list(secondary_previous_graphs or [])
        uuid_map = {}
        for prev_g, cur_g in zip(previous_graphs, current_graphs):
            FactorGraph._reconcile_graph(uuid_map, prev_g, cur_g)
        return uuid_map

    @staticmethod
    def _reconcile_graph(uuid_map, prev_g, cur_g):
        from ..modules.module import Module
        cur_nodes = list(cur_g.components_graph.nodes)
        cur_by_name = {c.name: c for c in cur_nodes if c.name}
        pairs = []
        matched_prev = set()
        matched_cur = set()

        def match(p, c):
            if p.uuid in matched_prev or c.uuid in matched_cur:
                return
            uuid_map[p.uuid] = c.uuid
            matched_prev.add(p.uuid)
            matched_cur.add(c.uuid)
            pairs.append((p, c))
            # recurse into module internal graphs
            if isinstance(c, Module) and \
                    getattr(p, "_module_graphs_json", None):
                c.reconcile_with_module_json(uuid_map, p._module_graphs_json)

        for p in prev_g.components_graph.nodes:
            if p.name and p.name in cur_by_name:
                match(p, cur_by_name[p.name])
        # cross-graph identity seeds: posterior graphs replicate model
        # variables keeping the UUID, so a node matched while reconciling
        # an earlier graph anchors the BFS here even when this graph has
        # no named nodes at all
        cur_by_uuid = {c.uuid: c for c in cur_nodes}
        for p in prev_g.components_graph.nodes:
            mapped = uuid_map.get(p.uuid)
            if mapped is not None and mapped in cur_by_uuid:
                match(p, cur_by_uuid[mapped])

        def _warn_if_ambiguous(label, anchor, plist, clist):
            """Parallel same-label edges pair positionally (in networkx's
            insertion order): when more than one still-unmatched, unnamed
            candidate shares a label, the pairing is a guess; say so."""
            amb_p = [pp for pp in plist
                     if pp.uuid not in matched_prev and not pp.name]
            amb_c = [cc for cc in clist
                     if cc.uuid not in matched_cur and not cc.name]
            if len(amb_p) > 1 and len(amb_c) > 1:
                warnings.warn(
                    "reconcile: {} unnamed components reach '{}' (a "
                    "{}) through parallel '{}' edges; pairing them "
                    "positionally. Name these components to make the "
                    "match deterministic. Candidates (previous): {}; "
                    "(current): {}.".format(
                        len(amb_p), anchor.name or anchor.uuid,
                        type(anchor).__name__, label,
                        [pp.uuid for pp in amb_p],
                        [cc.uuid for cc in amb_c]),
                    stacklevel=2)

        def expand(p, c, edges_of, end):
            p_nbrs = {}
            for e in edges_of(prev_g)(p, keys=True):
                p_nbrs.setdefault(e[2], []).append(e[end])
            c_nbrs = {}
            for e in edges_of(cur_g)(c, keys=True):
                c_nbrs.setdefault(e[2], []).append(e[end])
            for k, plist in p_nbrs.items():
                clist = c_nbrs.get(k, [])
                _warn_if_ambiguous(k, p, plist, clist)
                for pp, cc in zip(plist, clist):
                    match(pp, cc)

        # BFS expansion over labeled edges in both directions
        i = 0
        while i < len(pairs):
            p, c = pairs[i]
            i += 1
            expand(p, c, lambda g: g.components_graph.in_edges, 0)
            expand(p, c, lambda g: g.components_graph.out_edges, 1)
        return uuid_map
