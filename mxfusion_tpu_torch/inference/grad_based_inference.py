"""Gradient-based inference drivers.

Counterpart of ``mxfusion_tpu/inference/grad_based_inference.py``.
"""
from .inference import Inference, TransferInference, _data_shapes
from .inference_alg import create_executor
from .batch_loop import BatchInferenceLoop
from .minibatch_loop import MinibatchInferenceLoop
from ..util.inference import discover_shape_constants


class GradBasedInference(Inference):
    """Inference driven by a gradient loop."""

    def __init__(self, inference_algorithm, grad_loop=None, constants=None,
                 dtype=None, device=None):
        if grad_loop is None:
            grad_loop = BatchInferenceLoop()
        super().__init__(inference_algorithm=inference_algorithm,
                         constants=constants, dtype=dtype, device=device)
        self._grad_loop = grad_loop

    @property
    def grad_loop(self):
        return self._grad_loop

    def _bind_minibatch_shapes(self, data):
        """For minibatch loops, symbolic data dims bind to the batch size
        (rollover makes every batch the same size)."""
        B = self._grad_loop.batch_size
        shapes = {uuid: (min(B, s[0]),) + tuple(s[1:]) for uuid, s in
                  _data_shapes(self.observed_variable_UUIDs, data).items()}
        self.params.constants.update(
            discover_shape_constants(shapes, self.graphs))

    def run(self, optimizer="adam", learning_rate=1e-3, max_iter=2000,
            verbose=False, generator=None, callback=None, data_sharding=None,
            remat=False, rv_scaling=None, resume_state=None, **kwargs):
        """Train. ``rv_scaling``: {variable or uuid: scalar or array}
        factors multiplying a random variable's elementwise log-density
        (the minibatch loops take theirs from the loop). An array of the
        variable's event rank is an observation mask or per-point weight
        (0 = a missing entry, whose placeholder value is then irrelevant);
        module-generated variables take scalars only. Parameters already
        in the store (from :meth:`initialize`, a carry-over or an earlier
        run) are kept; ``generator`` (a ``torch.Generator``) draws the
        missing initial values and the loop's random numbers.
        ``data_sharding``: one ``parallel.Sharding`` per observed array,
        for a data-parallel run over a mesh (``parallel``). ``remat``:
        recompute the objective's activations in the backward pass
        (:func:`~.inference_alg.create_executor`)."""
        data = self._fetch_observed(kwargs)
        if isinstance(self._grad_loop, MinibatchInferenceLoop):
            if rv_scaling is not None:
                raise ValueError(
                    "pass rv_scaling to MinibatchInferenceLoop for "
                    "minibatch runs (it composes with the N/B "
                    "correction there).")
            self._bind_minibatch_shapes(data)
            self.params.initialize_params(
                self.graphs, self.observed_variable_UUIDs,
                generator=generator)
            self._initialized = True
            rv_scaling = self._grad_loop.rv_scaling
        else:
            self.initialize(generator=generator, **kwargs)
            if rv_scaling is not None:
                rv_scaling = {(k.uuid if hasattr(k, "uuid") else k): v
                              for k, v in rv_scaling.items()}
        executor = create_executor(self._algorithm, self.params,
                                   rv_scaling=rv_scaling, remat=remat)
        return self._grad_loop.run(
            executor=executor, params=self.params, data=data,
            optimizer=optimizer, learning_rate=learning_rate,
            max_iter=max_iter, generator=generator, verbose=verbose,
            callback=callback, data_sharding=data_sharding,
            resume_state=resume_state)


class GradTransferInference(GradBasedInference, TransferInference):
    """Gradient-based inference warm-started (and frozen) from a previous
    run's parameters; ``train_params`` re-enables training for selected
    carried-over variables."""

    def __init__(self, inference_algorithm, infr_params, grad_loop=None,
                 train_params=None, constants=None, dtype=None,
                 device=None):
        TransferInference.__init__(
            self, inference_algorithm=inference_algorithm,
            infr_params=infr_params, constants=constants, dtype=dtype,
            device=device, fix_carryover=True)
        self._grad_loop = grad_loop if grad_loop is not None \
            else BatchInferenceLoop()
        self._train_params = train_params

    def run(self, optimizer="adam", learning_rate=1e-3, max_iter=2000,
            verbose=False, generator=None, callback=None, **kwargs):
        data = self._fetch_observed(kwargs)
        self.initialize(generator=generator, **kwargs)
        for v in self._train_params or ():
            self.params.fixed.discard(v.uuid if hasattr(v, "uuid") else v)
        executor = create_executor(self._algorithm, self.params)
        return self._grad_loop.run(
            executor=executor, params=self.params, data=data,
            optimizer=optimizer, learning_rate=learning_rate,
            max_iter=max_iter, generator=generator, verbose=verbose,
            callback=callback)
