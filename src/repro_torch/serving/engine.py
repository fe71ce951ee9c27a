"""Micro-batching request engine over the top-K scorer (port of
``repro/serving/engine.py``).

Requests arrive one user at a time; the scorer wants batches. A worker
thread drains up to ``max(buckets)`` queued requests, pads the batch to the
nearest bucket size (the last user id repeats; pad rows are dropped on the
way out), scores it, and resolves each request's future with its
``(values (k,), indices (k,))``. ``submit`` never blocks: a full bounded
queue raises the named ``BackpressureError`` (counted on
``serve/backpressure``). Shutdown is a sentinel: the batch being collected
is served first, then everything still queued is cancelled.

Latency is measured submit to result into the ``serve/latency_ms``
reservoir of the metrics registry (``repro_torch.obs``, Vitter's algorithm
R with a per-series seed: exact percentiles up to ``lat_capacity``
requests, a uniform sample after); QPS is over the window from the first
accepted submit to the last result.

Tier-2 features (DESIGN.md §14), all composable:

  * **Two-stage retrieval** (``two_stage_c=C``): per shard, a coarse scan
    in the packed code domain keeps ``C·k`` candidates and only those are
    dequantized for the fp32 re-rank (``scorer.two_stage_topk``); stage
    times land on ``serve/stage_ms{stage=coarse|rerank}`` and the
    dequantized share on ``serve/candidate_frac``.
  * **Item shards** (``item_shards=S``): the item table is split by rows
    and the shards scored on a thread pool, then merged on the host by
    ``merge_topk``, bit-identical to the one-shard ranking. With
    ``shard_devices=True`` and at least S visible cards, shard i lives on
    ``cuda:i``; otherwise all shards share the store's device. On the card
    each shard runs on a CUDA stream of its own, so its stage times count
    its own work only.
  * **Hot-user cache** (``cache_size=N``): version-stamped LRU of per-user
    results, looked up when a batch is drained; hits resolve at once and
    take no batch slot (``cache.py`` has the invalidation rules).
  * **Incremental refresh** (``refresh(new_store_or_delta)``): applied on
    the worker thread between batches, so requests enqueued before it are
    served from the old store and those after from the new one; bumps
    ``serve/store_version`` and invalidates cache entries per the delta.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.quant import QTensor
from repro_torch.obs import get_registry, span

from .cache import ResultCache
from .refresh import StoreDelta, apply_delta, store_delta
from .scorer import merge_topk, topk_scores, two_stage_topk
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


def _rows(t) -> int:
    return t.rows if isinstance(t, QTensor) else int(t.shape[0])


def _shard_items(items, n_shards: int):
    """Row-shards of the item table (global ids are restored by adding each
    shard's offset to its indices)."""
    if n_shards == 1:
        return [items]
    bounds = np.linspace(0, _rows(items), n_shards + 1, dtype=int)
    if isinstance(items, QTensor):
        return [items.select(slice(a, b))
                for a, b in zip(bounds[:-1], bounds[1:])]
    return [items[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def _to(t, dev: torch.device):
    if isinstance(t, QTensor):
        return dataclasses.replace(t, packed=t.packed.to(dev),
                                   scale=t.scale.to(dev), zero=t.zero.to(dev))
    return t.to(dev)


# queue message kinds
_REQ, _REFRESH = "req", "refresh"


class ServingEngine:
    """Bounded-queue micro-batching server over a store.

    exclude : optional (U, P) int32 per-user item-id lists (-1 pads),
              excluded from every response for that user.
    buckets : ascending padded batch sizes; ``max(buckets)`` is also the
              per-iteration drain limit.
    item_shards : split the item table into S row shards scored
              concurrently and merged on the host (bit-exact).
    two_stage_c : candidate multiplier C for two-stage retrieval (None:
              single-stage scan; needs a packed store).
    shard_devices : put shard i on ``cuda:i`` when at least S cards are
              visible (else every shard stays on the store's device).
    cache_size : capacity of the hot-user result cache (0: off).
    max_pending : submit-queue bound.
    lat_capacity : reservoir size of the latency and stage histograms.
    registry : the ``MetricsRegistry`` to meter on (default: the process's).
    """

    _SEQ = itertools.count()

    def __init__(self, store: QuantizedEmbeddingStore, *, k: int = 20,
                 exclude=None, buckets=(1, 4, 16, 64), item_shards: int = 1,
                 two_stage_c: int | None = None, shard_devices: bool = False,
                 cache_size: int = 0, max_pending: int = 1024,
                 lat_capacity: int = 4096, registry=None):
        if two_stage_c is not None:
            if two_stage_c < 1:
                raise ValueError(f"two_stage_c must be >= 1, "
                                 f"got {two_stage_c}")
            if not isinstance(store.items, QTensor):
                raise ValueError(
                    "two-stage retrieval needs a packed (INT8/INT4) item "
                    "table; an fp32 store has no packed domain to "
                    "coarse-scan: drop two_stage_c or quantize the store")
        self.store = store
        self.k = k
        self.buckets = tuple(sorted(buckets))
        self.two_stage_c = two_stage_c
        self.n_shards = item_shards
        self.max_pending = max_pending
        dev = store.device
        self.exclude = (torch.as_tensor(np.asarray(exclude, np.int32),
                                        device=dev)
                        if exclude is not None
                        else torch.full((store.n_users, 1), -1,
                                        dtype=torch.int32, device=dev))
        self._devices = None
        if (shard_devices and item_shards > 1 and dev.type == "cuda"
                and torch.cuda.device_count() >= item_shards):
            self._devices = [torch.device("cuda", i)
                             for i in range(item_shards)]
        self._build_shards()
        self._streams = None
        if item_shards > 1 and dev.type == "cuda":
            self._streams = [torch.cuda.Stream(device=d) for d in
                             (self._devices or [dev] * item_shards)]
        self._pool = (ThreadPoolExecutor(max_workers=item_shards,
                                         thread_name_prefix="shard")
                      if item_shards > 1 else None)
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending)
        self._thread: threading.Thread | None = None
        self.version = 0
        reg = registry if registry is not None else get_registry()
        label = f"engine{next(self._SEQ)}"
        self.label = label
        self._cache = (ResultCache(cache_size, registry=reg, label=label)
                       if cache_size else None)
        self._m_lat = reg.histogram("serve/latency_ms", engine=label,
                                    capacity=lat_capacity)
        self._m_stage = {
            s: reg.histogram("serve/stage_ms", engine=label, stage=s,
                             capacity=lat_capacity)
            for s in ("coarse", "rerank")} if two_stage_c else {}
        self._m_queue = reg.gauge("serve/queue_depth", engine=label)
        self._m_requests = reg.counter("serve/requests", engine=label)
        self._m_batches = reg.counter("serve/batches", engine=label)
        self._m_shed = reg.counter("serve/backpressure", engine=label)
        self._m_cand = reg.gauge("serve/candidate_frac", engine=label)
        self._m_version = reg.gauge("serve/store_version", engine=label)
        self._m_refresh_rows = reg.counter("serve/refresh_rows",
                                           engine=label)
        self._n_batches = 0
        self._t_first = self._t_last = None
        self._t_lock = threading.Lock()

    def _build_shards(self) -> None:
        shards = _shard_items(self.store.items, self.n_shards)
        if self._devices is not None:
            shards = [_to(s, d) for s, d in zip(shards, self._devices)]
        self._shards = shards
        self._shard_offsets = np.cumsum([0] + [_rows(s)
                                               for s in shards])[:-1]

    # -- scoring ------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _score_shard(self, q, excl, shard, off, stream=None, ready=None):
        """One shard's local top-k (global exclusion ids shifted into shard
        space; ids outside it never match), on ``stream`` once ``ready``
        (the event after q and excl were formed) has fired.

        Stage timings are returned, not observed here: this runs on shard
        pool threads, and ``Histogram.observe`` has a single writer, so the
        caller folds them into the reservoirs on its own thread.
        """
        if stream is None:
            return self._score_local(q, excl, shard, off)
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            return self._score_local(q, excl, shard, off)

    def _score_local(self, q, excl, shard, off):
        k = min(self.k, _rows(shard))
        if self._devices is not None:
            dev = (shard.packed if isinstance(shard, QTensor)
                   else shard).device
            q, excl = q.to(dev), excl.to(dev)
        stage_t: list = []
        if self.two_stage_c is not None:
            cb = ((lambda stage, dt: stage_t.append((stage, dt)))
                  if self._m_stage else None)
            v, i = two_stage_topk(q, shard, k, c=self.two_stage_c,
                                  exclude=excl - int(off), stage_cb=cb)
        else:
            v, i = topk_scores(q, shard, k, exclude=excl - int(off))
        return v.cpu().numpy(), i.cpu().numpy() + int(off), stage_t

    def _observe_stages(self, stage_t) -> None:
        for stage, dt in stage_t:
            self._m_stage[stage].observe(dt * 1e3)

    def score_batch(self, user_ids: np.ndarray):
        """Top-K for a batch of user ids, padded to the nearest bucket.

        Returns (values (n, k), indices (n, k)) numpy arrays for the n real
        requests. Always scores: the cache sits in the drain loop. Batches
        larger than ``max(buckets)`` are scored in chunks of the largest
        bucket.
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
        excl = self.exclude[ids]
        if self.two_stage_c is not None:
            m = sum(min(self.two_stage_c * self.k, _rows(s))
                    for s in self._shards)
            self._m_cand.set(m / max(self.store.n_items, 1))
        if len(self._shards) == 1:
            vals, idx, stage_t = self._score_shard(q, excl, self._shards[0],
                                                   0)
            self._observe_stages(stage_t)
            return vals[:n], idx[:n]
        streams, ready = self._streams or [None] * len(self._shards), None
        if self._streams is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(q.device))
        futs = [self._pool.submit(self._score_shard, q, excl, shard, off,
                                  stream, ready)
                for off, shard, stream in zip(self._shard_offsets,
                                              self._shards, streams)]
        parts = [f.result() for f in futs]
        for p in parts:
            self._observe_stages(p[2])
        vals, idx = merge_topk([p[0] for p in parts], [p[1] for p in parts],
                               self.k)
        return vals[:n], idx[:n]

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
            self._queue.put_nowait((_REQ, int(user_id), now, fut))
        except queue.Full:
            self._m_shed.inc()
            raise BackpressureError(
                f"serving queue full ({self.max_pending} pending); "
                f"request shed: retry with backoff or raise max_pending"
            ) from None
        if self._t_first is None:
            with self._t_lock:
                if self._t_first is None:
                    self._t_first = now
        return fut

    def refresh(self, new_store_or_delta) -> Future:
        """Schedule an incremental store refresh; resolves to the delta's
        stats and the new version.

        Takes a full re-rolled ``QuantizedEmbeddingStore`` (diffed against
        the live store) or a ``StoreDelta``. Applied on the worker thread
        between batches: every request enqueued before this call is served
        from the old store, every one after from the new. The control
        message is put with a blocking put: it is never shed.
        """
        if self._thread is None:
            raise RuntimeError("engine not started (use `with engine:`)")
        fut: Future = Future()
        self._queue.put((_REFRESH, new_store_or_delta, fut))
        return fut

    def _serve_loop(self) -> None:
        """Cache hits resolve at once and take no batch slot: a batch fills
        with up to ``max(buckets)`` misses. A refresh met while a batch is
        collected is applied after that batch is served."""
        max_b = self.buckets[-1]
        while True:
            msg = self._queue.get()
            if msg is None:
                self._cancel_pending()
                return
            if msg[0] == _REFRESH:
                self._apply_refresh(msg[1], msg[2])
                continue
            misses = []
            refresh = None
            stop = False
            self._hit_or_collect(msg, misses)
            while len(misses) < max_b:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True       # serve the collected batch first
                    break
                if nxt[0] == _REFRESH:
                    refresh = nxt
                    break
                self._hit_or_collect(nxt, misses)
            if misses:
                self._drain_batch(misses)
            self._m_queue.set(float(self._queue.qsize()))
            if stop:
                self._cancel_pending()
                return
            if refresh is not None:
                self._apply_refresh(refresh[1], refresh[2])

    def _hit_or_collect(self, msg, misses: list) -> None:
        """Resolve a request from the cache now, or queue it for the
        scoring batch."""
        if self._cache is not None:
            ent = self._cache.get(msg[1])
            if ent is not None:
                self._replay(msg, ent)
                return
        misses.append(msg)

    def _replay(self, msg, ent) -> None:
        """Resolve a request from a cache entry ``(version, values,
        indices)``; the stamp equals ``self.version`` (refresh invalidates
        eagerly)."""
        self._resolve(msg, (ent[1], ent[2]))

    def _resolve(self, msg, result) -> None:
        _, _, t0, fut = msg
        now = time.perf_counter()
        self._t_last = now
        self._m_lat.observe((now - t0) * 1e3)
        self._m_requests.inc()
        fut.set_result(result)

    def _cancel_pending(self) -> None:
        """Shutdown: anything still queued behind the sentinel is
        cancelled, so no future blocks forever."""
        while True:
            try:
                msg = self._queue.get_nowait()
            except queue.Empty:
                return
            if msg is not None:
                msg[-1].cancel()

    def _apply_refresh(self, payload, fut: Future) -> None:
        """Apply a delta on the worker thread and invalidate the cache."""
        try:
            delta = (payload if isinstance(payload, StoreDelta)
                     else store_delta(self.store, payload))
            self.store = apply_delta(self.store, delta)
            self._build_shards()
            self.version += 1
            if self._cache is not None:
                if len(delta.item_ids):
                    self._cache.clear()     # every ranking is stale
                else:
                    if len(delta.user_ids):
                        self._cache.drop(delta.user_ids)
                    self._cache.restamp(self.version)   # the rest hold
            self._m_version.set(float(self.version))
            self._m_refresh_rows.inc(delta.n_changed)
            fut.set_result({**delta.stats(), "version": self.version})
        except Exception as e:       # surface to the caller, keep serving
            fut.set_exception(e)

    def _drain_batch(self, batch) -> None:
        """Score a batch of cache misses and resolve their futures."""
        ids = np.array([m[1] for m in batch], np.int64)
        try:
            with span("serve/batch", n=len(batch)):
                vals, idx = self.score_batch(ids)
        except Exception as e:   # the worker keeps serving; callers see it
            for m in batch:
                m[-1].set_exception(e)
            return
        self._n_batches += 1
        self._m_batches.inc()
        for pos, msg in enumerate(batch):
            if self._cache is not None:
                self._cache.put(msg[1], self.version, vals[pos], idx[pos])
            self._resolve(msg, (vals[pos], idx[pos]))

    def __enter__(self) -> "ServingEngine":
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._queue.put(None)
        self._thread.join(timeout=60.0)
        alive = self._thread.is_alive()
        self._thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if alive:
            raise RuntimeError("serving worker did not stop within 60 s")

    def stats(self) -> EngineStats:
        h = self._m_lat.snapshot()
        n = int(self._m_requests.value)
        window = max((self._t_last or 0) - (self._t_first or 0), 1e-9)
        return EngineStats(
            n_requests=n,
            qps=n / window if n else 0.0,
            p50_ms=h["p50"] if n else 0.0,
            p99_ms=h["p99"] if n else 0.0,
            n_batches=self._n_batches,
            cache_hit_rate=(self._cache.hit_rate if self._cache else 0.0),
            store_version=self.version)
