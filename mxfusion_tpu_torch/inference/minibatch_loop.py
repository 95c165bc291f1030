"""Minibatch gradient loop.

Counterpart of ``mxfusion_tpu/inference/minibatch_loop.py``. Shuffled
fixed-size batches with rollover (every batch has the same size B); the
``rv_scaling = N/B`` correction is folded into ``log_pdf_scaling`` when
the executor is built. Each epoch's permutation is the native batcher's
(``native.shuffled_indices(N, seed=epoch)``, the splitmix64
Fisher-Yates both packages build from the same source) where the C++
compiler builds it, and numpy's ``default_rng(epoch)`` otherwise: the
JAX loader's rule, so the port trains on JAX's batches on either kind of
host. Batches are gathered on the host by ``native.gather_rows``.

``batches_per_call = k`` gathers k batches into one pinned host buffer
and moves them to the device in ONE host-to-device copy, then runs k
optimizer steps on its slices. JAX scans the k steps inside one XLA
program to amortize dispatch; PyTorch runs eagerly and launches the
same kernels either way, so here k saves host-to-device copies and
their waits, not launches. The epoch's batches are padded to a multiple
of k by wrapping, as in JAX, so an epoch takes ``ceil(n_batches / k) *
k`` steps.
"""
import time

import numpy as np
import torch

from .grad_loop import GradLoop
from ..native import gather_rows, shuffled_indices
from ..util.profiling import span


def _aligned(nbytes, to=64):
    return -(-nbytes // to) * to


class MinibatchInferenceLoop(GradLoop):
    def __init__(self, batch_size=100, rv_scaling=None,
                 batches_per_call=1, metrics_callback=None):
        super().__init__()
        self.batch_size = batch_size
        self.rv_scaling = {v.uuid: s for v, s in rv_scaling.items()} \
            if rv_scaling is not None else None
        self.batches_per_call = batches_per_call
        # metrics_callback(epoch, {"loss", "grad_norm", "epoch_time_s"}),
        # loss and gradient norm averaged over the epoch
        self.metrics_callback = metrics_callback
        #: host-to-device copies the host loop made (one a call)
        self.h2d_copies = 0

    def _epoch_batches(self, N, epoch):
        """Shuffled index batches of epoch ``epoch`` (rollover-padded to
        the batch size ``min(batch_size, N)``, the size the symbolic
        batch dim is bound to), from ``native.shuffled_indices(N,
        seed=epoch)``, as the JAX loop takes them."""
        B = min(self.batch_size, N)
        perm = shuffled_indices(N, seed=epoch)
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

    def _epoch_calls(self, N, epoch):
        """The epoch's index batches grouped k to a call, padded to a
        multiple of k by wrapping (``minibatch_loop.py:175-176`` of the
        JAX package, whose index runs past the batches when an epoch has
        fewer than k; here it wraps there too)."""
        k = max(1, self.batches_per_call)
        batches = self._epoch_batches(N, epoch)
        n = len(batches)
        while len(batches) % k:
            batches.append(batches[len(batches) % k % n])
        return [batches[c:c + k] for c in range(0, len(batches), k)]

    def _rows_of(self, idx):
        """This rank's part of a global index batch (its last axis):
        its contiguous block under a sharding plan, the whole batch
        otherwise."""
        if self._plan is None or self._plan.gather:
            return idx
        return idx[..., self._plan.lo:self._plan.hi]

    def _epochs(self, executor, params, optimizer, learning_rate,
                max_iter, generator, verbose, callback, resume_state,
                epoch_calls):
        """The epoch loop all minibatch loops share; ``epoch_calls(e)``
        yields, call by call, the list of that call's batches."""
        trainable, fixed, opt, generator, start = self._start(
            params, optimizer, learning_rate, generator, resume_state)
        metrics_cb = self.metrics_callback
        last_loss = None
        for e in range(start, max_iter):
            t0 = time.perf_counter()
            call_means = []
            gnorms = []
            for batches in epoch_calls(e):
                losses = []
                for batch in batches:
                    loss, aux, gnorm = self._step(
                        executor, opt, trainable, fixed, batch, generator,
                        grad_norm=metrics_cb is not None)
                    if aux:
                        fixed = {**fixed, **aux}
                    losses.append(loss)
                    gnorms.append(gnorm)
                    last_loss = loss
                call_means.append(torch.mean(torch.stack(losses)))
            # the mean of the calls' means (JAX's epoch loss); one host
            # sync per epoch
            with span("loop.sync"):
                epoch_loss = float(torch.mean(torch.stack(call_means)))
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
        self._finish()
        return last_loss.cpu().numpy() if last_loss is not None else None

    def _stage(self, data, idx, device):
        """The rows ``idx`` (k, b) of every array, gathered into one host
        buffer (pinned when the device is a card) and moved to ``device``
        in one copy; returns, per batch, the list of its arrays (views of
        the device buffer)."""
        k, b = idx.shape
        flat = idx.reshape(-1)
        sizes = [_aligned(k * b * d[0].nbytes) for d in data]
        host = torch.empty(sum(sizes), dtype=torch.uint8,
                           pin_memory=device.type == "cuda")
        buf = host.numpy()
        views, off = [], 0
        for d, size in zip(data, sizes):
            n = k * b * d[0].nbytes
            out = buf[off:off + n].view(d.dtype).reshape((k * b,) +
                                                          d.shape[1:])
            gather_rows(d, flat, out=out)
            views.append((off, n, torch.from_numpy(out[:0]).dtype,
                          d.shape[1:]))
            off += size
        dev = host.to(device, non_blocking=True)
        self.h2d_copies += 1
        arrays = [dev[o:o + n].view(dt).reshape((k, b) + tuple(shape))
                  for o, n, dt, shape in views]
        return [[a[i] for a in arrays] for i in range(k)]

    def run(self, executor, params, data, optimizer="adam",
            learning_rate=1e-3, max_iter=1000, generator=None,
            verbose=False, callback=None, data_sharding=None,
            resume_state=None):
        """``max_iter`` counts epochs. ``resume_state`` (a
        :class:`~.grad_loop.TrainState`, step = epoch) skips the epochs
        already done; each epoch's shuffle is seeded by its number, so
        the resumed run equals the uninterrupted one.
        ``data_sharding``: one ``parallel.Sharding`` per array; every
        rank shuffles alike and takes its block of each batch."""
        data = [np.ascontiguousarray(d) for d in data]
        N = data[0].shape[0]
        executor = self._data_parallel(executor, data_sharding,
                                       min(self.batch_size, N))

        def epoch_calls(e):
            for idx in self._epoch_calls(N, e):
                yield self._stage(data, self._rows_of(np.stack(idx)),
                                  params.device)

        return self._epochs(executor, params, optimizer, learning_rate,
                            max_iter, generator, verbose, callback,
                            resume_state, epoch_calls)
