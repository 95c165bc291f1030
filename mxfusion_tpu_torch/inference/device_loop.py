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
compares the two overrides ``_epoch_batches``.

``data_sharding`` (one ``parallel.Sharding`` per array) keeps only this
rank's block of the rows resident. By default every rank draws the same
global permutation, so a batch holds rows of every rank: each rank puts
the batch rows it owns in place and one ``all_reduce`` (a sum over
disjoint rows) assembles the batch, of which the rank evaluates its
block. ``shard_local_shuffle=True`` permutes each rank's own rows
instead (stratified sampling without replacement per shard, the same
unbiased estimator, each row still seen once an epoch): a batch is the
union of every rank's local draw, and assembling it moves no rows.
"""
import torch
import torch.distributed as dist

from .minibatch_loop import MinibatchInferenceLoop
from ..util.profiling import span


class DeviceMinibatchLoop(MinibatchInferenceLoop):
    """Minibatch SVI with the dataset resident in device memory."""

    def __init__(self, batch_size=100, rv_scaling=None,
                 metrics_callback=None, shard_local_shuffle=False):
        super().__init__(batch_size=batch_size, rv_scaling=rv_scaling,
                         metrics_callback=metrics_callback)
        # requires data_sharding, and N and B divisible by the data axis
        self.shard_local_shuffle = shard_local_shuffle
        self._perm_generator = None

    def _epoch_batches(self, N, epoch):
        """Index batches of epoch ``epoch``, as a (n_batches, B) tensor on
        the device: a ``torch.randperm`` of the loop's generator seeded by
        ``epoch``, padded by wrapping to whole batches of B."""
        B = min(self.batch_size, N)
        n_batches = max(1, -(-N // B))
        with span("loop.shuffle"):
            g = self._perm_generator.manual_seed(epoch)
            perm = torch.randperm(N, generator=g, device=g.device)
            pad = n_batches * B - N
            if pad:
                perm = torch.cat([perm, perm.repeat(-(-pad // N))[:pad]])
            return perm.reshape(n_batches, B)

    def _local_epoch_batches(self, Nl, Bl, epoch, n, index):
        """Shard-local index batches of rank ``index`` of ``n``: the
        epoch's generator draws one permutation of Nl rows per shard (every
        rank draws all n, so each shard's is the same on every rank and in
        a one-process run), padded by wrapping; (n_batches, Bl) local row
        indices."""
        n_batches = max(1, -(-Nl // Bl))
        g = self._perm_generator.manual_seed(epoch)
        perms = [torch.randperm(Nl, generator=g, device=g.device)
                 for _ in range(n)]
        perm = perms[index]
        pad = n_batches * Bl - Nl
        if pad:
            perm = torch.cat([perm, perm.repeat(-(-pad // Nl))[:pad]])
        return perm.reshape(n_batches, Bl)

    def run(self, executor, params, data, optimizer="adam",
            learning_rate=1e-3, max_iter=1000, generator=None,
            verbose=False, callback=None, data_sharding=None,
            resume_state=None):
        """``max_iter`` counts epochs (as in MinibatchInferenceLoop)."""
        device = params.device
        self._perm_generator = torch.Generator(device=device)
        N = int(data[0].shape[0])
        B = min(self.batch_size, N)
        if self.shard_local_shuffle:
            if data_sharding is None:
                raise ValueError(
                    "shard_local_shuffle=True requires data_sharding "
                    "(the resident dataset must live sharded on a mesh).")
            if not all(s.is_shard for s in data_sharding):
                raise ValueError(
                    "shard_local_shuffle=True shards every array: give "
                    "each a batch_sharding.")
            n_sh = data_sharding[0].n_shards
            if N % n_sh or B % n_sh:
                raise ValueError(
                    "shard_local_shuffle needs N ({}) and batch size "
                    "({}) divisible by the data-axis size ({})."
                    .format(N, B, n_sh))
        executor = self._data_parallel(executor, data_sharding, B)
        plan = self._plan
        if plan is None:
            resident = [torch.as_tensor(d, device=device) for d in data]

            def epoch_calls(e):
                for idx in self._epoch_batches(N, e):
                    # the span closes before the step runs on the batch
                    with span("loop.gather"):
                        idx = torch.as_tensor(idx, device=device)
                        batch = [torch.index_select(d, 0, idx)
                                 for d in resident]
                    yield [batch]
            return self._epochs(executor, params, optimizer, learning_rate,
                                max_iter, generator, verbose, callback,
                                resume_state, epoch_calls)

        # sharded residency: this rank's block of each sharded array
        resident = [plan.resident(d, s, N, device)
                    for d, s in zip(data, plan.shardings)]
        lo = plan.sharding.block(N)[0]
        Nl = N // plan.n

        if self.shard_local_shuffle:
            Bl = B // plan.n

            def batch_of(local_idx):
                # this rank's draw; the batch is the union of every
                # rank's (gathered only when the objective needs it whole)
                own = [torch.index_select(d, 0, local_idx)
                       for d in resident]
                return [plan.all_gather(x) for x in own] if plan.gather \
                    else own

            def epoch_calls(e):
                for idx in self._local_epoch_batches(
                        Nl, Bl, e, plan.n, plan.sharding.index):
                    yield [batch_of(idx)]
        else:
            def batch_of(idx):
                out = []
                for d, s in zip(resident, plan.shardings):
                    if not s.is_shard:
                        full = torch.index_select(d, 0, idx)
                    else:
                        # the rows this rank owns, in place; a sum over
                        # the axis assembles the whole batch
                        owned = (idx >= lo) & (idx < lo + Nl)
                        full = torch.zeros((idx.shape[0],) + d.shape[1:],
                                           dtype=d.dtype, device=device)
                        full[owned] = d[idx[owned] - lo]
                        dist.all_reduce(full, group=plan.sharding.group)
                    out.append(full if plan.gather
                               else full[plan.lo:plan.hi])
                return out

            def epoch_calls(e):
                for idx in self._epoch_batches(N, e):
                    yield [batch_of(torch.as_tensor(idx, device=device))]

        return self._epochs(executor, params, optimizer, learning_rate,
                            max_iter, generator, verbose, callback,
                            resume_state, epoch_calls)
