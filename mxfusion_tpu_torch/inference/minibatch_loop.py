"""Minibatch gradient loop.

Counterpart of ``mxfusion_tpu/inference/minibatch_loop.py``. Shuffled
fixed-size batches with rollover (every batch has the same size B); the
``rv_scaling = N/B`` correction is folded into ``log_pdf_scaling`` when
the executor is built. Batches are gathered on the host and moved to the
device one at a time.
"""
import time

import numpy as np
import torch

from .grad_loop import GradLoop


class MinibatchInferenceLoop(GradLoop):
    def __init__(self, batch_size=100, rv_scaling=None,
                 metrics_callback=None):
        super().__init__()
        self.batch_size = batch_size
        self.rv_scaling = {v.uuid: s for v, s in rv_scaling.items()} \
            if rv_scaling is not None else None
        # metrics_callback(epoch, {"loss", "grad_norm", "epoch_time_s"}),
        # loss and gradient norm averaged over the epoch
        self.metrics_callback = metrics_callback

    def _epoch_batches(self, N, epoch):
        """Shuffled index batches of epoch ``epoch`` (rollover-padded to
        the batch size ``min(batch_size, N)``, the size the symbolic
        batch dim is bound to).

        The permutation is ``np.random.default_rng(epoch).permutation(N)``:
        the JAX loader's own fallback (``native/loader.py:88-92``), which
        the JAX package uses where its native batcher is not built. The
        port's native batcher is not ported yet."""
        B = min(self.batch_size, N)
        perm = np.random.default_rng(epoch).permutation(N)
        out = []
        for b in range(max(1, -(-N // B))):
            idx = perm[b * B:(b + 1) * B]
            if idx.shape[0] < B:
                # tile the permutation so that even B > 2 * remaining
                # pads to exactly B
                idx = np.concatenate([idx, np.resize(perm,
                                                     B - idx.shape[0])])
            out.append(idx)
        return out

    def _epochs(self, executor, params, data, optimizer, learning_rate,
                max_iter, generator, verbose, callback, resume_state,
                gather):
        """The epoch loop both minibatch loops share; ``gather(idx)``
        returns the batch of index array ``idx``."""
        trainable, fixed, opt, generator, start = self._start(
            params, optimizer, learning_rate, generator, resume_state)
        N = data[0].shape[0]
        metrics_cb = self.metrics_callback
        last_loss = None
        for e in range(start, max_iter):
            t0 = time.perf_counter()
            losses = []
            gnorms = []
            for idx in self._epoch_batches(N, e):
                loss, aux, gnorm = self._step(
                    executor, opt, trainable, fixed, gather(idx), generator,
                    grad_norm=metrics_cb is not None)
                if aux:
                    fixed = {**fixed, **aux}
                losses.append(loss)
                gnorms.append(gnorm)
                last_loss = loss
            # one host sync per epoch
            epoch_loss = float(torch.mean(torch.stack(losses)))
            if verbose:
                print("epoch {} loss: {}".format(e + 1, epoch_loss))
            if callback is not None or metrics_cb is not None:
                self._sync_live_state(params, trainable, fixed, opt,
                                      generator, step=e + 1)
            if callback is not None:
                callback(e, epoch_loss)
            if metrics_cb is not None:
                metrics_cb(e, {
                    "loss": epoch_loss,
                    "grad_norm": float(torch.mean(torch.stack(gnorms))),
                    "epoch_time_s": time.perf_counter() - t0})
        self._sync_live_state(params, trainable, fixed, opt, generator,
                              step=max_iter)
        return last_loss.cpu().numpy() if last_loss is not None else None

    def run(self, executor, params, data, optimizer="adam",
            learning_rate=1e-3, max_iter=1000, generator=None,
            verbose=False, callback=None, resume_state=None):
        """``max_iter`` counts epochs. ``resume_state`` (a
        :class:`~.grad_loop.TrainState`, step = epoch) skips the epochs
        already done; each epoch's shuffle is seeded by its number, so
        the resumed run equals the uninterrupted one."""
        data = [np.asarray(d) for d in data]

        def gather(idx):
            return [torch.as_tensor(d[idx], device=params.device)
                    for d in data]

        return self._epochs(executor, params, data, optimizer,
                            learning_rate, max_iter, generator, verbose,
                            callback, resume_state, gather)
