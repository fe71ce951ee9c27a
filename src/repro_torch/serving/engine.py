"""Micro-batching request engine over the top-K scorer (port of
``repro/serving/engine.py``, single stage).

Requests arrive one user at a time; the scorer wants batches. A worker
thread drains up to ``max(buckets)`` queued requests, pads the batch to the
nearest bucket size (the last user id repeats; pad rows are dropped on the
way out), scores it, and resolves each request's future with its
``(values (k,), indices (k,))``. ``submit`` never blocks: a full bounded
queue raises the named ``BackpressureError``. Shutdown is a sentinel: the
batch being collected is served first, then everything still queued is
cancelled.

Latency is measured submit to result and kept in a bounded ring buffer of
the most recent ``lat_capacity`` requests; p50/p99 are nearest-rank over it.
QPS is over the window from the first accepted submit to the last result.
Item shards, the hot-user cache, refresh and two-stage retrieval are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from .scorer import topk_scores
from .store import QuantizedEmbeddingStore

__all__ = ["ServingEngine", "EngineStats", "BackpressureError"]


class BackpressureError(RuntimeError):
    """The engine's bounded submit queue is full; shed or retry later."""


@dataclasses.dataclass(frozen=True)
class EngineStats:
    n_requests: int
    qps: float
    p50_ms: float
    p99_ms: float
    n_batches: int
    cache_hit_rate: float = 0.0
    store_version: int = 0

    def __str__(self) -> str:
        return (f"{self.n_requests} req | {self.qps:.0f} QPS | "
                f"p50 {self.p50_ms:.2f}ms p99 {self.p99_ms:.2f}ms | "
                f"{self.n_batches} batches | "
                f"cache {self.cache_hit_rate:.0%} | v{self.store_version}")


class ServingEngine:
    """Bounded-queue micro-batching server over a store.

    exclude : optional (U, P) int32 per-user item-id lists (-1 pads),
              excluded from every response for that user.
    buckets : ascending padded batch sizes; ``max(buckets)`` is also the
              per-iteration drain limit.
    max_pending : submit-queue bound.
    """

    def __init__(self, store: QuantizedEmbeddingStore, *, k: int = 20,
                 exclude=None, buckets=(1, 4, 16, 64),
                 max_pending: int = 1024, lat_capacity: int = 4096):
        self.store = store
        self.k = k
        self.buckets = tuple(sorted(buckets))
        self.max_pending = max_pending
        dev = store.device
        self.exclude = (torch.as_tensor(np.asarray(exclude, np.int32),
                                        device=dev)
                        if exclude is not None
                        else torch.full((store.n_users, 1), -1,
                                        dtype=torch.int32, device=dev))
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending)
        self._thread: threading.Thread | None = None
        self._lat = np.zeros(lat_capacity, np.float64)
        self._n_requests = 0
        self._n_batches = 0
        self._t_first = self._t_last = None
        self._t_lock = threading.Lock()

    # -- scoring ------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def score_batch(self, user_ids: np.ndarray):
        """Top-K for a batch of user ids, padded to the nearest bucket.

        Returns (values (n, k), indices (n, k)) numpy arrays for the n real
        requests. Batches larger than ``max(buckets)`` are scored in chunks
        of the largest bucket.
        """
        n = len(user_ids)
        max_b = self.buckets[-1]
        if n > max_b:
            parts = [self.score_batch(user_ids[a:a + max_b])
                     for a in range(0, n, max_b)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        b = self._bucket(n)
        padded = np.asarray(user_ids, np.int64)
        if b > n:
            padded = np.concatenate([padded, np.full(b - n, padded[-1])])
        ids = torch.from_numpy(padded).to(self.exclude.device)
        q = self.store.user_vectors(ids)
        vals, idx = topk_scores(q, self.store.items, self.k,
                                exclude=self.exclude[ids])
        return vals[:n].cpu().numpy(), idx[:n].cpu().numpy()

    def warmup(self) -> None:
        """Score every bucket once, so the first requests pay no start-up
        (kernel build and load, allocator growth)."""
        for b in self.buckets:
            self.score_batch(np.zeros(b, np.int64))

    # -- request loop -------------------------------------------------------

    def submit(self, user_id: int) -> Future:
        """Enqueue one request; resolves to (values (k,), indices (k,)).
        Raises ``BackpressureError`` when the bounded queue is full."""
        if self._thread is None:
            raise RuntimeError("engine not started (use `with engine:`)")
        fut: Future = Future()
        now = time.perf_counter()
        try:
            self._queue.put_nowait((int(user_id), now, fut))
        except queue.Full:
            raise BackpressureError(
                f"serving queue full ({self.max_pending} pending); "
                f"request shed: retry with backoff or raise max_pending"
            ) from None
        if self._t_first is None:
            with self._t_lock:
                if self._t_first is None:
                    self._t_first = now
        return fut

    def _serve_loop(self) -> None:
        max_b = self.buckets[-1]
        while True:
            msg = self._queue.get()
            if msg is None:
                self._cancel_pending()
                return
            batch = [msg]
            stop = False
            while len(batch) < max_b:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True       # serve the collected batch first
                    break
                batch.append(nxt)
            self._drain_batch(batch)
            if stop:
                self._cancel_pending()
                return

    def _cancel_pending(self) -> None:
        while True:
            try:
                msg = self._queue.get_nowait()
            except queue.Empty:
                return
            if msg is not None:
                msg[-1].cancel()

    def _drain_batch(self, batch) -> None:
        ids = np.array([m[0] for m in batch], np.int64)
        try:
            vals, idx = self.score_batch(ids)
        except Exception as e:   # the worker keeps serving; callers see it
            for m in batch:
                m[-1].set_exception(e)
            return
        self._n_batches += 1
        for pos, (_, t0, fut) in enumerate(batch):
            now = time.perf_counter()
            self._t_last = now
            self._lat[self._n_requests % len(self._lat)] = (now - t0) * 1e3
            self._n_requests += 1
            fut.set_result((vals[pos], idx[pos]))

    def __enter__(self) -> "ServingEngine":
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._queue.put(None)
        self._thread.join(timeout=60.0)
        alive = self._thread.is_alive()
        self._thread = None
        if alive:
            raise RuntimeError("serving worker did not stop within 60 s")

    def stats(self) -> EngineStats:
        n = self._n_requests
        lat = np.sort(self._lat[:min(n, len(self._lat))])

        def pct(p):
            return float(lat[min(int(len(lat) * p / 100.0), len(lat) - 1)]) \
                if len(lat) else 0.0

        window = max((self._t_last or 0) - (self._t_first or 0), 1e-9)
        return EngineStats(n_requests=n, qps=n / window if n else 0.0,
                           p50_ms=pct(50), p99_ms=pct(99),
                           n_batches=self._n_batches)
