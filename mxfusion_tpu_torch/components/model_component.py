"""Graph-node base class for the model IR.

Counterpart of ``mxfusion_tpu/components/model_component.py``, and plain
Python like it: every component has a UUID identity, lives either in
*bi-directional mode* (free-standing, keeping its own
predecessor/successor lists) or in *graph mode* (adjacency delegated to
the owning FactorGraph's ``networkx.MultiDiGraph``), and supports
replication that preserves UUIDs so model and posterior graphs can
share variable identity. Edges are stored as MultiDiGraph edge *keys*
(the named-slot label, e.g. ``'mean'``).
"""
import uuid as _uuid

from ..common.exceptions import ModelSpecificationError


class ModelComponent:
    """A node in a factor graph: either a :class:`Variable` or a :class:`Factor`.

    Identity is the UUID — hashing and equality use only the UUID, so a
    replicated component (same UUID, different graph) is "the same"
    component for dict/set purposes.
    """

    def __init__(self):
        self._uuid = _uuid.uuid4().hex
        self.name = None
        # Attributes: variables referenced from this component's shape
        # (symbolic dimensions) that must migrate into a graph with it.
        self.attributes = []
        self._parent_graph = None  # networkx.MultiDiGraph when in graph mode
        # Bi-directional mode storage: lists of (edge_label, component).
        self._predecessors = []
        self._successors = []

    # ------------------------------------------------------------------
    # identity
    # ------------------------------------------------------------------
    @property
    def uuid(self):
        return self._uuid

    def __hash__(self):
        return hash(self._uuid)

    def __eq__(self, other):
        return isinstance(other, ModelComponent) and other._uuid == self._uuid

    def __repr__(self):
        cls = type(self).__name__
        return "{}({})".format(cls, self.name if self.name else self._uuid[:8])

    # ------------------------------------------------------------------
    # graph mode vs bi-directional mode
    # ------------------------------------------------------------------
    @property
    def graph(self):
        return self._parent_graph

    @graph.setter
    def graph(self, nx_graph):
        """Migrate this node (plus its bi-directional neighborhood) into a graph.

        One-way migration: once a component belongs to a graph it
        cannot be re-attached to a different one.
        """
        if nx_graph is None:
            raise ModelSpecificationError(
                "Cannot detach component {} from its graph.".format(self))
        if self._parent_graph is nx_graph:
            return
        if self._parent_graph is not None:
            raise ModelSpecificationError(
                "Component {} already belongs to a graph; components cannot "
                "be moved between graphs (replicate it instead).".format(self))
        # Breadth-first migration of the connected bi-directional component.
        pending = [self]
        seen = set()
        while pending:
            node = pending.pop()
            if node.uuid in seen:
                continue
            seen.add(node.uuid)
            if node._parent_graph is nx_graph:
                continue
            if node._parent_graph is not None:
                raise ModelSpecificationError(
                    "Component {} is attached to a different graph.".format(node))
            preds, succs = node._predecessors, node._successors
            node._predecessors, node._successors = [], []
            node._parent_graph = nx_graph
            nx_graph.add_node(node)
            for attr in node.attributes:
                if isinstance(attr, ModelComponent) and attr._parent_graph is None:
                    attr._parent_graph = nx_graph
                    nx_graph.add_node(attr)
                elif isinstance(attr, ModelComponent):
                    nx_graph.add_node(attr)
            for label, pred in preds:
                pending.append(pred)
                nx_graph.add_edge(pred, node, key=label)
            for label, succ in succs:
                pending.append(succ)
                nx_graph.add_edge(node, succ, key=label)

    # ------------------------------------------------------------------
    # adjacency (named edges)
    # ------------------------------------------------------------------
    @property
    def predecessors(self):
        """Ordered list of ``(edge_label, component)`` feeding into this node."""
        if self._parent_graph is None:
            return list(self._predecessors)
        return [(key, pred)
                for pred, _, key in self._parent_graph.in_edges(self, keys=True)]

    @predecessors.setter
    def predecessors(self, preds):
        if self._parent_graph is None:
            self._predecessors = list(preds)
        else:
            g = self._parent_graph
            for pred, _, key in list(g.in_edges(self, keys=True)):
                g.remove_edge(pred, self, key=key)
            for label, pred in preds:
                if pred._parent_graph is None:
                    pred.graph = g
                g.add_edge(pred, self, key=label)

    @property
    def successors(self):
        """Ordered list of ``(edge_label, component)`` this node feeds into."""
        if self._parent_graph is None:
            return list(self._successors)
        return [(key, succ)
                for _, succ, key in self._parent_graph.out_edges(self, keys=True)]

    @successors.setter
    def successors(self, succs):
        if self._parent_graph is None:
            self._successors = list(succs)
        else:
            g = self._parent_graph
            for _, succ, key in list(g.out_edges(self, keys=True)):
                g.remove_edge(self, succ, key=key)
            for label, succ in succs:
                if succ._parent_graph is None:
                    succ.graph = g
                g.add_edge(self, succ, key=label)

    def add_predecessor(self, label, pred):
        """Add one named input edge ``pred --label--> self``."""
        if self._parent_graph is None and pred._parent_graph is not None:
            # Align modes: pull self into pred's graph.
            self.graph = pred._parent_graph
        if self._parent_graph is not None:
            if pred._parent_graph is None:
                pred.graph = self._parent_graph
            self._parent_graph.add_edge(pred, self, key=label)
        else:
            self._predecessors.append((label, pred))
            pred._successors.append((label, self))

    def add_successor(self, label, succ):
        """Add one named output edge ``self --label--> succ``."""
        if self._parent_graph is None and succ._parent_graph is not None:
            self.graph = succ._parent_graph
        if self._parent_graph is not None:
            if succ._parent_graph is None:
                succ.graph = self._parent_graph
            self._parent_graph.add_edge(self, succ, key=label)
        else:
            self._successors.append((label, succ))
            succ._predecessors.append((label, self))

    # ------------------------------------------------------------------
    # replication
    # ------------------------------------------------------------------
    def replicate_self(self, attribute_map=None):
        """Return a copy of this node with the SAME UUID and no edges.

        Subclasses override to copy their payload. ``attribute_map`` maps
        old attribute Variables to their replicas.
        """
        replica = type(self).__new__(type(self))
        ModelComponent.__init__(replica)
        replica._uuid = self._uuid
        replica.name = self.name
        if attribute_map is not None:
            replica.attributes = [attribute_map.get(a, a) for a in self.attributes]
        else:
            replica.attributes = list(self.attributes)
        return replica

    def _replicate_self_with_attributes(self, var_map):
        """Replicate this node (memoized in ``var_map``) along with its
        attribute Variables."""
        if self in var_map:
            return var_map[self]
        attr_map = {}
        for a in self.attributes:
            if not isinstance(a, ModelComponent):
                continue
            if a in var_map:
                attr_map[a] = var_map[a]
            else:
                attr_map[a] = a.replicate_self()
                var_map[a] = attr_map[a]
        replica = self.replicate_self(attribute_map=attr_map)
        var_map[self] = replica
        return replica

    def _replicate_neighbors(self, var_map, neighbors, recurse_type,
                             replication_function):
        if recurse_type == "recursive":
            return [(name, n.replicate(var_map=var_map,
                                       replication_function=replication_function))
                    for name, n in neighbors]
        if recurse_type == "one_level":
            return [(name, n._replicate_self_with_attributes(var_map))
                    for name, n in neighbors]
        if recurse_type is None:
            return []
        raise ModelSpecificationError(
            "recurse_type must be 'recursive', 'one_level' or None, got "
            "{}.".format(recurse_type))

    def replicate(self, var_map=None, replication_function=None):
        """Replicate this component and its neighborhood.

        ``replication_function(component) -> (pred_direction,
        succ_direction)`` with directions in {'recursive', 'one_level',
        None} controls propagation per node. Replicas are left in
        bi-directional mode; both link directions are maintained.
        """
        var_map = var_map if var_map is not None else {}
        if self in var_map:
            return var_map[self]
        replica = self._replicate_self_with_attributes(var_map)
        if replication_function is not None:
            pred_rec, succ_rec = replication_function(self)
        else:
            pred_rec, succ_rec = None, None
        preds = self._replicate_neighbors(var_map, self.predecessors,
                                          pred_rec, replication_function)
        succs = self._replicate_neighbors(var_map, self.successors,
                                          succ_rec, replication_function)
        replica._predecessors = preds
        replica._successors = succs
        for label, p in preds:
            if not any(l == label and s is replica for l, s in p._successors):
                p._successors.append((label, replica))
        for label, s in succs:
            if not any(l == label and p is replica
                       for l, p in s._predecessors):
                s._predecessors.append((label, replica))
        return replica

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def as_json(self):
        return {
            "uuid": self._uuid,
            "name": self.name,
            "type": type(self).__name__,
            "attributes": [a.uuid for a in self.attributes
                           if isinstance(a, ModelComponent)],
        }
