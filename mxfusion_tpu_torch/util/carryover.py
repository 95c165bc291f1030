"""Carry trained parameters into the port's parameter store.

A model built with the JAX package and the same model built with this
package have different UUIDs, so parameters cannot be matched by UUID.
They are matched by *name path* instead:

* a named variable of a top-level graph (model or posterior) is its
  name: ``noise_var``;
* an unnamed one is the label of the edge that feeds it into a factor:
  the module input ``inducing_inputs``;
* a variable of a module's internal graphs is prefixed with the module's
  name, or with the name of its first output: ``Y.qU_mean``,
  ``Y.qU_cov_W``, ``Y.qU_cov_diag``, and the kernel's
  ``Y.rbf_lengthscale`` and ``Y.rbf_variance``.

The walk reads only what the graph classes of both packages share
(``components_graph``, ``name``, ``uuid``, ``successors``, ``outputs``,
``internal_graphs``), so it runs on either package's graphs and imports
no JAX.
"""
import numpy as np
import torch

from ..inference.inference_parameters import InferenceParameters


def _is_variable(component):
    return hasattr(component, "transformation") and \
        hasattr(component, "shape")


def name_paths(graphs):
    """``{uuid: name path}`` for every variable of ``graphs`` and of the
    internal graphs of the modules in them. Raises when two variables
    would share a path."""
    paths = {}
    owners = {}

    def add(uuid, path):
        if uuid in paths:
            return
        if path in owners:
            raise ValueError(
                "two variables share the name path {!r}; name them to "
                "tell them apart.".format(path))
        paths[uuid] = path
        owners[path] = uuid

    def walk(graph, prefix):
        nodes = list(graph.components_graph.nodes)
        variables = [c for c in nodes if _is_variable(c)]
        for v in variables:
            if v.name:
                add(v.uuid, prefix + v.name)
        for v in variables:
            if not v.name and v.successors:
                add(v.uuid, prefix + v.successors[0][0])
        for c in nodes:
            if hasattr(c, "internal_graphs"):
                name = c.name or c.outputs[0][1].name
                for g in c.internal_graphs:
                    walk(g, prefix + name + ".")

    for g in graphs:
        walk(g, "")
    return paths


def carryover_params(state, graphs, source_graphs=None, dtype=None,
                     device=None):
    """The port's :class:`InferenceParameters` holding ``state``.

    ``state``: ``{key: array}`` of unconstrained values (the JAX
    package's layout; numpy arrays or tensors). Its keys are name paths,
    or, when ``source_graphs`` (the graphs the state was trained on, of
    either package) are given, UUIDs of those graphs, translated to name
    paths by the same walk. ``graphs``: the port's model (and posterior)
    graphs. Raises on any array that finds no match.
    """
    if source_graphs is not None:
        source_paths = name_paths(source_graphs)
        unknown = [k for k in state if k not in source_paths]
        if unknown:
            raise KeyError("parameter(s) {} are no variables of the source "
                           "graphs.".format(unknown))
        state = {source_paths[k]: v for k, v in state.items()}
    by_path = {p: u for u, p in name_paths(graphs).items()}
    unmatched = sorted(k for k in state if k not in by_path)
    if unmatched:
        raise KeyError(
            "no variable of the target graphs has the name path(s) {}; "
            "known paths: {}.".format(unmatched, sorted(by_path)))
    params = InferenceParameters(dtype=dtype, device=device)
    for path, value in state.items():
        if not isinstance(value, torch.Tensor):
            value = np.array(value)  # a writable copy (JAX's are not)
        params.param_dict[by_path[path]] = params.as_tensor(value)
    return params
