"""Device-resident minibatch gradient loop.

Counterpart of ``mxfusion_tpu/inference/device_loop.py``. The dataset is
put on the device once, and every batch is gathered there from a
per-epoch permutation: host traffic per epoch is the permutation's
indices and one loss. Rollover semantics match
:class:`~.minibatch_loop.MinibatchInferenceLoop`, and
:meth:`_epoch_batches` stays the one place that makes the index batches.

The permutation comes from ``torch.randperm`` with the loop's own
generator on the device, seeded by the epoch number as the host loop's
shuffle is, so a resumed run shuffles as the uninterrupted one. It
differs from the JAX loop's ``jax.random.permutation``; a test that
compares the two overrides ``_epoch_batches``. The JAX option
``shard_local_shuffle`` waits for the port's parallel slice and raises.
"""
import torch

from .minibatch_loop import MinibatchInferenceLoop


class DeviceMinibatchLoop(MinibatchInferenceLoop):
    """Minibatch SVI with the dataset resident in device memory."""

    def __init__(self, batch_size=100, rv_scaling=None,
                 metrics_callback=None, shard_local_shuffle=False):
        if shard_local_shuffle:
            raise NotImplementedError(
                "shard_local_shuffle needs a sharded dataset; the port's "
                "parallel slice is not ported yet.")
        super().__init__(batch_size=batch_size, rv_scaling=rv_scaling,
                         metrics_callback=metrics_callback)
        self._perm_generator = None

    def _epoch_batches(self, N, epoch):
        """Index batches of epoch ``epoch``, as a (n_batches, B) tensor on
        the device: a ``torch.randperm`` of the loop's generator seeded by
        ``epoch``, padded by wrapping to whole batches of B."""
        B = min(self.batch_size, N)
        n_batches = max(1, -(-N // B))
        g = self._perm_generator.manual_seed(epoch)
        perm = torch.randperm(N, generator=g, device=g.device)
        pad = n_batches * B - N
        if pad:
            perm = torch.cat([perm, perm.repeat(-(-pad // N))[:pad]])
        return perm.reshape(n_batches, B)

    def run(self, executor, params, data, optimizer="adam",
            learning_rate=1e-3, max_iter=1000, generator=None,
            verbose=False, callback=None, resume_state=None):
        """``max_iter`` counts epochs (as in MinibatchInferenceLoop)."""
        data = [torch.as_tensor(d, device=params.device) for d in data]
        self._perm_generator = torch.Generator(device=params.device)

        def gather(idx):
            idx = torch.as_tensor(idx, device=params.device)
            return [torch.index_select(d, 0, idx) for d in data]

        return self._epochs(executor, params, data, optimizer,
                            learning_rate, max_iter, generator, verbose,
                            callback, resume_state, gather)
