"""Serving traffic: one client in a closed loop sends a request, waits
for its numpy result and sends the next, through the port's
``BatchedPredictor.predict``.

Each request is a slice of one host array of ``pool_rows`` rows (numpy
float32, made on the device from the seed and copied to the host once).
The sizes are one fixed set, ``sizes`` of them evenly spread over
[``min_rows``, ``max_rows``], dealt in a fresh seeded order each round,
so every seed sends the same work in another order; the offsets are
drawn from the seed. A request's latency runs from its send to its
result in hand. After the window, every row of ``check_requests``
requests drawn from the seed among those served, the longest served
among them, is held against the reference.

Parameters (the workload's ``traffic`` object): ``pool_rows``,
``min_rows``, ``max_rows``, ``sizes``, ``chunk``, ``check_requests``,
``trace_requests`` (the window of a traced run).
"""
import math
import time

import numpy as np

from ..lib import compare
from ..lib.phases import phase_logger


class Cell:
    """One serving cell: ``setup``, ``window``, ``release``, ``check``."""

    def __init__(self, workload, config, cfg, reference, seed, device):
        self.traffic = workload["traffic"]
        self.config, self.cfg, self.reference = config, cfg, reference
        self.seed, self.device = seed, device
        self.rng = np.random.default_rng(seed)

    def _generator(self, offset):
        import torch
        return torch.Generator(self.device).manual_seed(
            (self.seed * 8 + offset) % 2 ** 63)

    def _schedule(self):
        """Request sizes and offsets, round after round, forever."""
        tr = self.traffic
        lo, hi, k = tr["min_rows"], tr["max_rows"], tr["sizes"]
        sizes = [lo + int((i + 0.5) * (hi - lo) / k) for i in range(k)]
        while True:
            for n in self.rng.permutation(sizes):
                yield int(n), int(self.rng.integers(0, tr["pool_rows"] - n
                                                    + 1))

    def setup(self, seconds, log=lambda *a: None):
        phase = phase_logger(log)
        self.seconds = seconds
        from mxfusion_tpu_torch.inference import BatchedPredictor
        from mxfusion_tpu_torch.util.carryover import carryover_params
        phase("import")
        cfg, tr = self.cfg, self.traffic
        self.pool = (self.config.data(cfg, tr["pool_rows"],
                                      self._generator(1))[0]
                     .cpu().numpy())
        self.state = self.config.served_state(cfg, self._generator(2))
        phase("request rows and state on the card, rows to the host")
        m = self.config.model(cfg)
        params = carryover_params({k: v.clone() for k, v in
                                   self.state.items()}, [m],
                                  dtype="float32", device=self.device)
        self.predictor = BatchedPredictor(
            model=m, infr_params=params, observed=[m.X],
            target_variables=[m.Y.uuid], chunk_size=tr["chunk"])
        self.requests = self._schedule()
        phase("model and predictor")
        # the one chunk shape every request runs (the last chunk padded)
        for n in (tr["max_rows"], tr["min_rows"]):
            self.predictor.predict(X=self.pool[:n])
            phase("warm-up request of {} rows".format(n))
        self.served = []

    def window(self, seconds=None, requests=None):
        """Serve until ``seconds`` (default: set-up's) have passed or
        ``requests`` are done; returns the window's work and time."""
        if requests is None and seconds is None:
            seconds = self.seconds
        latencies, rows, failed, chunks = [], 0, 0, 0
        chunk = self.traffic["chunk"]
        t0 = time.perf_counter()
        while True:
            n, off = next(self.requests)
            sent = time.perf_counter()
            try:
                out = self.predictor.predict(X=self.pool[off:off + n])[0]
            except Exception as e:  # a failed request counts, the loop goes on
                out = e
            done = time.perf_counter()
            latencies.append(done - sent)
            rows += n
            chunks += -(-n // chunk)
            if isinstance(out, Exception) or not all(
                    np.isfinite(a).all() for a in out):
                failed += 1
            else:
                self.served.append((n, off, out))
            if (seconds is not None and done - t0 >= seconds) or \
                    (requests is not None and len(latencies) >= requests):
                break
        return {"seconds": done - t0, "requests": len(latencies),
                "rows": rows, "chunks": chunks, "failed": failed,
                "latencies": latencies}

    def trace_window(self):
        return {"requests": self.traffic["trace_requests"]}

    def counts(self, out):
        return {k: out[k] for k in ("requests", "rows", "chunks")}

    def model_flops(self, counts):
        return counts["rows"] * self.config.flops_per_row(self.cfg)

    def k1_launches(self, counts):
        """K1's launches in the window, as (S, N, M, D, L)."""
        return counts["chunks"] * self.config.k1_launches_per_chunk(
            self.cfg, self.traffic["chunk"])

    def end_to_end(self, out):
        p95 = float(np.percentile(np.asarray(out["latencies"]) * 1e3, 95))
        return {"serve_rows_per_s": (out["rows"] / out["seconds"], "rows/s"),
                "serve_p95_ms": (p95, "ms")}

    def attempted(self, out):
        return out["requests"]

    def failed(self, out):
        return out["failed"]

    def release(self):
        del self.predictor

    def checked(self):
        """The served requests held against the reference: a seeded draw
        of ``check_requests`` and the longest."""
        served = self.served
        if not served:
            return []
        k = min(self.traffic["check_requests"], len(served))
        pick = set(np.random.default_rng(self.seed + 1).choice(
            len(served), size=k, replace=False).tolist())
        pick.add(max(range(len(served)), key=lambda i: served[i][0]))
        return [served[i] for i in sorted(pick)]

    def check(self, control=None):
        """The numbers of :func:`compare.serving_numbers` of the program's
        answers or, with ``control`` (a precision of ``reference.common``),
        of the reference's at that precision."""
        import torch
        from ..reference.common import products_at
        pairs = []
        for n, off, (mu, var) in self.checked():
            X = torch.as_tensor(self.pool[off:off + n], device=self.device)
            with products_at("fp32"):
                want = [t.cpu().numpy() for t in self.reference.moments(
                    self.state, X, self.cfg, "fp32")]
            if control is None:
                got = [np.asarray(mu).reshape(n, -1),
                       np.asarray(var).reshape(n, -1)]
            else:
                with products_at(control):
                    got = [t.cpu().numpy() for t in self.reference.moments(
                        self.state, X, self.cfg, control)]
            pairs.append((got, want))
        if not pairs:
            return {"mean_gap": math.inf, "var_gap": math.inf}
        return compare.serving_numbers(pairs)
