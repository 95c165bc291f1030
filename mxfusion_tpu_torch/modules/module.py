"""Module: a factor bundling a sub-model with specialized inference.

Counterpart of ``mxfusion_tpu/modules/module.py``. A Module acts as a
factor during model definition, but ``log_pdf`` / ``draw_samples`` /
``predict`` dispatch to *attached inference algorithms* selected by
matching the (targets, conditionals) name pattern against what is
present in the runtime env.

Internal graphs replicate the module's input/output variables with the
SAME UUIDs, so the outer env is directly usable inside. Hidden internal
parameters (kernel hyperparameters, variational parameters) are
allocated into the outer :class:`InferenceParameters`; posterior cache
variables are allocated as fixed (non-trainable) storage.
"""
import warnings

from ..components.factor import Factor
from ..components.variables.variable import VariableType
from ..components.distributions.random_gen import default_rand_gen
from ..common.config import get_default_dtype
from ..common.exceptions import ModelSpecificationError


class Module(Factor):
    def __init__(self, inputs, outputs, input_names, output_names,
                 rand_gen=None, dtype=None):
        super().__init__(inputs=inputs, outputs=outputs,
                         input_names=input_names, output_names=output_names)
        self._rand_gen = rand_gen if rand_gen is not None \
            else default_rand_gen()
        self.dtype = dtype if dtype is not None else get_default_dtype()
        self._module_graph = None
        self._extra_graphs = []
        self._log_pdf_algorithms = {}
        self._draw_samples_algorithms = {}
        self._prediction_algorithms = {}
        self.log_pdf_scaling = 1.0
        self._cache_variables = []

    # ------------------------------------------------------------------
    @property
    def internal_graphs(self):
        return [self._module_graph] + self._extra_graphs

    def __contains__(self, key):
        uuid = key.uuid if hasattr(key, "uuid") else key
        return any(uuid in g.components for g in self.internal_graphs)

    def __getitem__(self, key):
        uuid = key.uuid if hasattr(key, "uuid") else key
        for g in self.internal_graphs:
            if uuid in g.components:
                return g.components[uuid]
        raise KeyError(uuid)

    # ------------------------------------------------------------------
    def _build_module_graphs(self):
        raise NotImplementedError

    def _attach_default_inference_algorithms(self):
        raise NotImplementedError

    def set_outputs(self, variables):
        """Wiring outputs triggers internal-graph construction and default
        algorithm attachment."""
        variables = [variables] if not isinstance(variables, (list, tuple)) \
            else variables
        self.successors = list(zip(self.output_names, variables))
        self._module_graph, self._extra_graphs = self._build_module_graphs()
        self._attach_default_inference_algorithms()

    def expose_hidden_parameters_as_input(self, name, variable):
        """Expose an internal-graph variable as a module input so users
        can place priors on it / share it."""
        if name in self.input_names:
            raise ModelSpecificationError(
                "Module {} already has an input named {}.".format(self,
                                                                  name))
        v = variable.replicate_self()
        self.input_names.append(name)
        self.add_predecessor(name, v)
        return v

    # ------------------------------------------------------------------
    # hidden parameters
    # ------------------------------------------------------------------
    @property
    def hidden_parameters(self):
        io_uuids = set(v.uuid for _, v in self.inputs) | \
            set(v.uuid for _, v in self.outputs)
        out = []
        for g in self.internal_graphs:
            out.extend(v.uuid for v in g.get_parameters(excluded=io_uuids))
        return out

    def initialize_hidden_parameters(self, params, excluded=None,
                                     generator=None):
        """Allocate internal parameters into the outer parameter store,
        drawing random initial values from ``generator``. Cache
        variables are allocated as zeros and marked fixed."""
        excluded = set(excluded) if excluded else set()
        io_uuids = set(v.uuid for _, v in self.inputs) | \
            set(v.uuid for _, v in self.outputs)
        cache_uuids = set(v.uuid for v in self._cache_variables)
        for g in self.internal_graphs:
            for v in g.get_constants():
                if v.uuid not in params.constants:
                    params.constants[v.uuid] = v.constant
        for g in self.internal_graphs:
            for v in g.get_parameters(excluded=io_uuids | excluded):
                if v.uuid in params.param_dict or \
                        v.uuid in params.constants:
                    # already allocated (e.g. loaded from a save):
                    # still (re-)mark cache variables as fixed so a
                    # resumed training run never trains cache state
                    if v.uuid in cache_uuids and \
                            v.uuid in params.param_dict:
                        params.fixed.add(v.uuid)
                    continue
                params.allocate(v, generator,
                                zero_init=v.uuid in cache_uuids)
                if v.uuid in cache_uuids:
                    params.fixed.add(v.uuid)

    def collect_internal_transformations(self):
        """{uuid: transformation} over internal parameters, merged into the
        executor's bijector table."""
        var_trans = {}
        for g in self.internal_graphs:
            for v in g.variables.values():
                if v.type == VariableType.PARAMETER and \
                        v.transformation is not None:
                    var_trans[v.uuid] = v.transformation
        return var_trans

    # ------------------------------------------------------------------
    # algorithm attachment
    # ------------------------------------------------------------------
    def attach_log_pdf_algorithms(self, targets, conditionals, algorithm,
                                  alg_name=None):
        self._attach_algorithm(self._log_pdf_algorithms, targets,
                               conditionals, algorithm, alg_name)

    def attach_draw_samples_algorithms(self, targets, conditionals,
                                       algorithm, alg_name=None):
        self._attach_algorithm(self._draw_samples_algorithms, targets,
                               conditionals, algorithm, alg_name)

    def attach_prediction_algorithms(self, targets, conditionals, algorithm,
                                     alg_name=None):
        self._attach_algorithm(self._prediction_algorithms, targets,
                               conditionals, algorithm, alg_name)

    def _attach_algorithm(self, algorithms, targets, conditionals, algorithm,
                          alg_name):
        targets = tuple(sorted(targets)) if targets is not None else None
        conditionals = tuple(sorted(conditionals)) \
            if conditionals is not None else None
        alg_name = self._set_algorithm_name(alg_name, algorithm)
        if conditionals not in algorithms:
            algorithms[conditionals] = [(targets, algorithm, alg_name)]
            return
        methods = algorithms[conditionals]
        for i, (i_targets, _, i_name) in enumerate(methods):
            if targets == i_targets:
                if i_name is not None and i_name != alg_name:
                    delattr(self, i_name)
                methods[i] = (targets, algorithm, alg_name)
                return
        methods.append((targets, algorithm, alg_name))

    def _set_algorithm_name(self, alg_name, algorithm):
        from ..inference.inference_alg import InferenceAlgorithm
        if alg_name is None:
            return None
        current = getattr(self, alg_name, None)
        if current is None or isinstance(current, InferenceAlgorithm):
            object.__setattr__(self, alg_name, algorithm)
            return alg_name
        warnings.warn(
            "Attribute {} already used on module {}; not naming the "
            "algorithm.".format(alg_name, self))
        return None

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def get_names_from_uuid(self, uuids):
        uuid_to_names = {v.uuid: k for k, v in self.inputs}
        uuid_to_names.update({v.uuid: k for k, v in self.outputs})
        return tuple(sorted(uuid_to_names[u] for u in uuids
                            if u in uuid_to_names))

    def _get_algorithm(self, algorithms, targets, env, exact_match=False):
        if targets is None:
            target_names = tuple(sorted(self.output_names))
        else:
            target_names = self.get_names_from_uuid(targets)
        conditionals_names = self.get_names_from_uuid(list(env.keys()))
        if exact_match:
            conditionals_names = tuple(
                sorted(set(conditionals_names) - set(target_names)))
        if conditionals_names in algorithms:
            target_set = set(target_names)
            for t, alg, _ in algorithms[conditionals_names]:
                if exact_match and target_set == set(t):
                    return alg
                if not exact_match and target_set <= set(t):
                    return alg
        raise ModelSpecificationError(
            "No inference algorithm matches the (targets, conditionals) "
            "pattern {}.".format((target_names, conditionals_names)))

    def log_pdf(self, env, targets=None, ctx=None):
        from ..inference.inference_alg import RuntimeContext
        alg = self._get_algorithm(self._log_pdf_algorithms, targets, env,
                                  exact_match=True)
        alg.log_pdf_scaling = self.log_pdf_scaling
        if ctx is None:
            # generator-less context: deterministic log-pdf algorithms
            # (the GP modules) run fine; anything that samples raises a
            # clear "pass a generator" error
            ctx = RuntimeContext(None)
        result = alg.compute(env, ctx)
        if isinstance(result, tuple):
            result = result[0]
        return result

    def draw_samples(self, env, generator, num_samples=1, targets=None):
        from ..inference.inference_alg import RuntimeContext
        alg = self._get_algorithm(self._draw_samples_algorithms, targets,
                                  env)
        alg.num_samples = num_samples
        alg.target_variables = targets
        return alg.compute(env, RuntimeContext(generator))

    def predict(self, env, generator, targets=None, num_samples=None):
        from ..inference.inference_alg import RuntimeContext
        alg = self._get_algorithm(self._prediction_algorithms, targets, env,
                                  exact_match=True)
        # None flows through: "unset" stays distinguishable from an
        # explicit 1 for algorithms with their own prediction default
        alg.num_samples = num_samples
        alg.target_variables = targets
        return alg.compute(env, RuntimeContext(generator))

    # ------------------------------------------------------------------
    # replication
    # ------------------------------------------------------------------
    def _clone_algorithms(self, algorithms, replicant):
        algs = {}
        graphs_index = {g: i for i, g in enumerate(self._extra_graphs)}
        for conditionals, methods in algorithms.items():
            cloned = []
            for targets, algorithm, alg_name in methods:
                extra = [replicant._extra_graphs[graphs_index[g]]
                         for g in algorithm.graphs if g in graphs_index]
                cloned.append((targets, algorithm.replicate_self(
                    replicant._module_graph, extra), alg_name))
            algs[conditionals] = cloned
        return algs

    def replicate_self(self, attribute_map=None):
        replicant = super().replicate_self(attribute_map)
        replicant._rand_gen = self._rand_gen
        replicant.dtype = self.dtype
        replicant.log_pdf_scaling = 1.0
        if self._module_graph is None:
            replicant._module_graph = None
            replicant._extra_graphs = []
            replicant._log_pdf_algorithms = {}
            replicant._draw_samples_algorithms = {}
            replicant._prediction_algorithms = {}
            replicant._cache_variables = []
            return replicant
        replicant._module_graph = self._module_graph.clone()
        replicant._extra_graphs = [
            g.clone(replicant._module_graph) for g in self._extra_graphs]
        replicant._log_pdf_algorithms = self._clone_algorithms(
            self._log_pdf_algorithms, replicant)
        replicant._draw_samples_algorithms = self._clone_algorithms(
            self._draw_samples_algorithms, replicant)
        replicant._prediction_algorithms = self._clone_algorithms(
            self._prediction_algorithms, replicant)
        cache_uuids = set(v.uuid for v in self._cache_variables)
        replicant._cache_variables = [
            v for g in replicant.internal_graphs
            for v in g.variables.values() if v.uuid in cache_uuids]
        return replicant

    def internal_graphs_as_json(self):
        return [g.as_json() for g in self.internal_graphs]

    def reconcile_with_module_json(self, uuid_map, module_graphs_json):
        """Recurse graph reconciliation into the module's internal
        graphs."""
        from ..models.factor_graph import FactorGraph
        prev_graphs = FactorGraph.load_graphs_json(module_graphs_json)
        for prev_g, cur_g in zip(prev_graphs, self.internal_graphs):
            FactorGraph._reconcile_graph(uuid_map, prev_g, cur_g)
        return uuid_map
