"""Full-batch gradient loop.

Counterpart of ``mxfusion_tpu/inference/batch_loop.py``. PyTorch runs
eagerly, so a step is the executor, ``backward`` and the optimizer's
update, with nothing to compile. ``steps_per_call`` keeps the JAX API
(the callback and ``verbose`` see every k-th step, and the loop runs
whole chunks of k steps) as a plain loop: its reason in JAX, amortizing
host dispatch over a ``lax.scan``, does not carry over.
"""
import time

from .grad_loop import GradLoop


class BatchInferenceLoop(GradLoop):
    """Optimize the objective on the full data every iteration."""

    def __init__(self, steps_per_call=1, debug=False, metrics_callback=None):
        self.steps_per_call = steps_per_call
        # JAX's debug=True runs its step un-jitted; the port always runs
        # eagerly, so the flag is accepted (JAX call sites run unchanged)
        # and changes nothing
        self.debug = debug
        # metrics_callback(i, {"loss", "grad_norm", "step_time_s"})
        self.metrics_callback = metrics_callback

    def run(self, executor, params, data, optimizer="adam",
            learning_rate=1e-3, max_iter=1000, generator=None,
            verbose=False, callback=None, data_sharding=None,
            resume_state=None):
        """``resume_state``: a :class:`~.grad_loop.TrainState`; the loop
        then runs the remaining ``max_iter - resume_state.step`` steps.
        ``data_sharding``: one ``parallel.Sharding`` per array; the step
        then evaluates this rank's rows and averages the loss and
        gradients over the data axis (``parallel.data_parallel``)."""
        trainable, fixed, opt, generator, start = self._start(
            params, optimizer, learning_rate, generator, resume_state)
        executor, data = self._full_batch(executor, data, data_sharding,
                                          params.device)
        k = max(1, self.steps_per_call)
        if start % k:
            raise ValueError(
                "resume_state.step={} is not a multiple of "
                "steps_per_call={}.".format(start, k))
        end = -(-max_iter // k) * k
        metrics_cb = self.metrics_callback
        print_every = max(1, max_iter // 10)
        loss = None
        for i in range(start, end):
            t0 = time.perf_counter()
            loss, aux, gnorm = self._step(
                executor, opt, trainable, fixed, data, generator,
                grad_norm=metrics_cb is not None)
            if aux:
                fixed = {**fixed, **aux}
            if (i + 1) % k:
                continue
            if verbose and (k > 1 or (i + 1) % print_every == 0 or i == 0):
                print("Iteration {} loss: {}".format(i + 1, float(loss)))
            if callback is not None or metrics_cb is not None:
                self._sync_live_state(params, trainable, fixed, opt,
                                      generator, step=i + 1)
            if callback is not None:
                callback(i, loss)
            if metrics_cb is not None:
                metrics_cb(i, {"loss": float(loss),
                               "grad_norm": float(gnorm),
                               "step_time_s": time.perf_counter() - t0})
        self._sync_live_state(params, trainable, fixed, opt, generator,
                              step=end)
        self._finish()
        return loss.cpu().numpy() if loss is not None else None
