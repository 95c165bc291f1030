"""Posterior: a FactorGraph over the same variables as its model.

Counterpart of ``mxfusion_tpu/models/posterior.py``. The load-bearing
trick is *replicate-on-access*: ``q.x`` lazily replicates the model's
variable ``x`` — with the SAME UUID — into the posterior graph, so
model and posterior share variable identity in the runtime env.
"""
from .factor_graph import FactorGraph
from ..components.model_component import ModelComponent


class Posterior(FactorGraph):
    def __init__(self, model, name="Posterior", verbose=False):
        super().__init__(name=name, verbose=verbose)
        object.__setattr__(self, "_model", model)

    @property
    def model(self):
        return self._model

    def __getitem__(self, key):
        """Replicate-on-access by Variable or UUID (same-UUID sharing)."""
        uuid = key.uuid if hasattr(key, "uuid") else key
        comps = self.components
        if uuid in comps:
            return comps[uuid]
        source = self._model.components.get(uuid)
        if source is None:
            raise KeyError(uuid)
        replica = source.replicate_self()
        replica.graph = self.components_graph
        if replica.name:
            object.__setattr__(self, replica.name, replica)
        return replica

    def __getattr__(self, name):
        # only called when normal lookup fails: replicate from the model
        if name.startswith("_"):
            raise AttributeError(name)
        model = self.__dict__.get("_model")
        if model is None:
            raise AttributeError(name)
        source = getattr(model, name, None)
        if not isinstance(source, ModelComponent):
            raise AttributeError(name)
        replica = source.replicate_self()
        replica.name = name
        replica.graph = self.components_graph
        object.__setattr__(self, name, replica)
        return replica

    def clone(self, model=None, leaves=None):
        new_graph = Posterior(model if model is not None else self._model,
                              name=self.name)
        var_map = {}
        targets = leaves if leaves is not None else self.leaves
        replicas = [leaf.replicate(
            var_map=var_map,
            replication_function=lambda c: ("recursive", "recursive"))
            for leaf in targets]
        for r in replicas:
            r.graph = new_graph.components_graph
        for comp in new_graph.components_graph.nodes:
            if comp.name is not None:
                object.__setattr__(new_graph, comp.name, comp)
        return new_graph
