"""Carry trained parameters into the port's parameter store.

A model built with the JAX package and the same model built with this
package have different UUIDs, so parameters cannot be matched by UUID.
They are matched by *name path* instead:

* a named variable of a top-level graph (model or posterior) is its
  name: ``noise_var``;
* an unnamed one is named by the label of the edge that feeds it into
  its first factor. A module input, and any unnamed variable of a
  module's internal graphs, is that label alone: ``inducing_inputs``.
  Any other input of a function or a distribution is
  qualified by what the factor produces: the path of a function's
  output (``p(z).mean.data`` for the constant that ``broadcast_to``
  spreads into z's prior mean), and for a distribution the random
  variable it describes, as ``mu.mean`` and ``tau.variance`` in a
  posterior (a mean-field posterior's parameters) and as ``p(mu).mean``
  in any other graph (the model's prior of mu). An unnamed random
  variable, such as a network's weight under a prior, stands in these
  by its own path: ``r.f_Dense_0_kernel.mean`` is q's mean of the
  weight that ``f`` feeds into ``r``, and ``p(r.f_Dense_0_kernel).mean``
  its prior's (the posterior's paths need the model walked first);
* a variable of a module's internal graphs is prefixed with the module's
  name, or with the name of its first output: ``Y.qU_mean``,
  ``Y.qU_cov_W``, ``Y.qU_cov_diag``, and the kernel's
  ``Y.rbf_lengthscale`` and ``Y.rbf_variance``. The SVGP family shares
  this layout (regression, classification, multi-class, Poisson); the
  negative binomial adds its default dispersion, a module input:
  ``dispersion``, and the LMC module its ``mixing_matrix``;
* where unnamed variables of one module graph share their label, each is
  qualified as at the top level: a deep GP's layers are indexed
  (``inducing_inputs_1``, ``Y.qU_mean_0``), and their kernels' parameters
  are ``Y.p(F_0).rbf_lengthscale``, ``Y.p(F_1).rbf_lengthscale`` (of the
  factors a variable feeds, the one whose path sorts first).

The state-space models carry as any distribution does: a
``LinearGaussianSSM``'s system matrices and noise covariances by their
names or, unnamed, as ``p(y).A``, ``p(y).trans_cov`` and
``p(y).obs_cov`` (the inputs of an operator that builds one, such as a
variance times I, as ``p(y).trans_cov.x``); a ``GaussianAR1``'s as
``p(x).phi`` and ``p(x).noise_var``. A PILCO inference carries its
policy weight by name beside the GP dynamics' state, the posterior
cache that the rollout reads included (``Y.X``, ``Y.L``, ``Y.LinvY``).

The walk reads only what the graph classes of both packages share
(``components_graph``, ``name``, ``uuid``, ``successors``, ``outputs``,
``internal_graphs``, ``random_variable`` and a posterior's ``model``),
so it runs on either package's graphs and imports no JAX.

A network's parameters are named after their path in the network
(``components.functions.NNFunction``), so a torch network laid out as
the flax one, ``Dense_i.kernel`` of shape (in, out) and ``Dense_i.bias``,
carries across as it is. A ``param_map`` carries a network of another
layout: ``{source name: (target name, transpose)}``, applied to every
component of a name path, with the value's last two axes swapped where
``transpose`` is set. ``linear_stack_map`` gives the map from flax's
Dense layers onto a stack of ``nn.Linear`` layers (weight (out, in)).
"""
import re

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
        posterior = hasattr(type(graph), "model")

        def unnamed(v):
            label, factor = v.successors[0]
            if prefix or hasattr(factor, "internal_graphs"):
                return label    # a module's input, or inside a module
            return owned(label, factor)

        def owned(label, factor):
            """``label`` qualified by what ``factor`` produces."""
            out = factor.outputs[0][1]
            if hasattr(factor, "random_variable"):
                # an unnamed random variable (a network's weight under a
                # prior) goes by its own path: in a posterior, where
                # nothing consumes it, the one its model gave it
                owner = out.name or (unnamed(out) if out.successors
                                     else paths.get(out.uuid))
                if owner is None:
                    return label
                if not posterior:
                    owner = "p({})".format(owner)
            elif out.name:
                owner = out.name
            elif out.successors:
                owner = unnamed(out)
            else:
                return label
            return owner + "." + label

        for v in variables:
            if v.name:
                add(v.uuid, prefix + v.name)
        anonymous = [v for v in variables if not v.name and v.successors]
        labels = [unnamed(v) for v in anonymous]
        for v, label in zip(anonymous, labels):
            if prefix and labels.count(label) > 1:
                # one label in one module graph, as the kernels' parameters
                # of a deep GP's layers: qualified by what a factor makes,
                # the least of them (cloning reorders the successors)
                label = min(owned(lb, f) for lb, f in v.successors)
            add(v.uuid, prefix + label)
        for c in nodes:
            if hasattr(c, "internal_graphs"):
                name = c.name or c.outputs[0][1].name
                for g in c.internal_graphs:
                    walk(g, prefix + name + ".")

    for g in graphs:
        walk(g, "")
    return paths


def linear_stack_map(name, module):
    """The ``param_map`` from flax's ``Dense_0``, ``Dense_1``, ... of a
    function named ``name`` onto the ``nn.Linear`` layers of ``module``
    in registration order: each kernel (in, out) onto the weight
    (out, in), transposed, and each bias onto the bias."""
    linears = [path for path, sub in module.named_modules()
               if isinstance(sub, torch.nn.Linear)]
    out = {}
    for i, path in enumerate(linears):
        prefix = "{}_{}_".format(name, path.replace(".", "_"))
        out["{}_Dense_{}_kernel".format(name, i)] = (prefix + "weight", True)
        out["{}_Dense_{}_bias".format(name, i)] = (prefix + "bias", False)
    return out


def apply_param_map(state, param_map):
    """``state`` (``{name path: array}``) with every path component
    named in ``param_map`` renamed, and the value transposed (its last
    two axes) where the entry says so. A path may run through one mapped
    name at most."""
    if not param_map:
        return dict(state)
    pattern = re.compile(r"(?<!\w)({})(?!\w)".format(
        "|".join(re.escape(k) for k in sorted(param_map, key=len,
                                              reverse=True))))
    out = {}
    for path, value in state.items():
        hits = pattern.findall(path)
        if len(hits) > 1:
            raise ValueError("the name path {!r} runs through {} mapped "
                             "parameters.".format(path, hits))
        if hits:
            target, transpose = param_map[hits[0]]
            path = pattern.sub(target, path)
            if transpose:
                value = value.transpose(-1, -2) if isinstance(
                    value, torch.Tensor) else np.swapaxes(value, -1, -2)
        out[path] = value
    return out


def _match(state, graphs, source_graphs, param_map=None):
    """``state`` re-keyed by the UUIDs of ``graphs``."""
    if source_graphs is not None:
        source_paths = name_paths(source_graphs)
        unknown = [k for k in state if k not in source_paths]
        if unknown:
            raise KeyError("parameter(s) {} are no variables of the source "
                           "graphs.".format(unknown))
        state = {source_paths[k]: v for k, v in state.items()}
    state = apply_param_map(state, param_map)
    by_path = {p: u for u, p in name_paths(graphs).items()}
    unmatched = sorted(k for k in state if k not in by_path)
    if unmatched:
        raise KeyError(
            "no variable of the target graphs has the name path(s) {}; "
            "known paths: {}.".format(unmatched, sorted(by_path)))
    return {by_path[path]: value for path, value in state.items()}


def load_state(params, state, graphs, source_graphs=None, param_map=None):
    """Overwrite entries of the port's :class:`InferenceParameters`
    ``params`` with ``state``, matched by name path, and return it.

    ``params`` may be a store that an inference has initialized (e.g.
    ``GradBasedInference.initialize(...)``): its constants, its ``fixed``
    set and every entry ``state`` does not name stay as they are, so
    training starts from ``state``. Keys, ``source_graphs`` and
    ``param_map`` as for :func:`carryover_params`."""
    for uuid, value in _match(state, graphs, source_graphs,
                              param_map).items():
        if not isinstance(value, torch.Tensor):
            value = np.array(value)  # a writable copy (JAX's are not)
        params.param_dict[uuid] = params.as_tensor(value)
    return params


def carryover_params(state, graphs, source_graphs=None, dtype=None,
                     device=None, param_map=None):
    """The port's :class:`InferenceParameters` holding ``state``.

    ``state``: ``{key: array}`` of unconstrained values (the JAX
    package's layout; numpy arrays or tensors). Its keys are name paths,
    or, when ``source_graphs`` (the graphs the state was trained on, of
    either package) are given, UUIDs of those graphs, translated to name
    paths by the same walk. ``graphs``: the port's model (and posterior)
    graphs. ``param_map``: network parameters renamed (and transposed)
    on the way, as :func:`apply_param_map` does; e.g.
    :func:`linear_stack_map` for a flax Dense stack carried onto
    ``nn.Linear`` layers. Raises on any array that finds no match.
    """
    return load_state(InferenceParameters(dtype=dtype, device=device),
                      state, graphs, source_graphs, param_map)
