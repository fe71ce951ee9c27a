"""Hot-user result cache: version-stamped LRU over engine responses (port
of ``repro/serving/cache.py``).

A recommendation for a user is a pure function of (user row, item table),
so until a refresh changes either, the engine can replay the previous
answer instead of scanning the store again. The cache is a bounded LRU of
``user_id -> (store_version, values, indices)``:

  * entries carry the store version they are valid for, and the engine
    invalidates eagerly at refresh time (``drop`` for changed user rows,
    ``clear`` when any item row changed, then ``restamp`` of the entries
    that survive a refresh that changed none of their rows), so a stale
    entry cannot be reached and a served hit's stamp equals the live
    version (the reference keeps the old stamp on the survivors);
  * all mutation happens on the engine's single worker thread (lookups
    while a batch is drained, invalidation while a refresh is applied), so
    the cache needs no lock; its hit/miss counters are registry metrics,
    safe to read from any thread.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch.obs import get_registry

__all__ = ["ResultCache"]


class ResultCache:
    """Bounded LRU of per-user top-K results (see module docstring)."""

    def __init__(self, capacity: int, *, registry=None, label: str = "cache"):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._od: OrderedDict[int, tuple] = OrderedDict()
        reg = registry if registry is not None else get_registry()
        self._m_hits = reg.counter("serve/cache_hits", engine=label)
        self._m_misses = reg.counter("serve/cache_misses", engine=label)
        self._m_size = reg.gauge("serve/cache_size", engine=label)
        self._m_evict = reg.counter("serve/cache_evictions", engine=label)
        self._m_inval = reg.counter("serve/cache_invalidations", engine=label)

    def __len__(self) -> int:
        return len(self._od)

    def get(self, user_id: int):
        """Hit -> (version, values, indices); miss -> None. Meters both."""
        ent = self._od.get(int(user_id))
        if ent is None:
            self._m_misses.inc()
            return None
        self._od.move_to_end(int(user_id))
        self._m_hits.inc()
        return ent

    def put(self, user_id: int, version: int, vals, idx) -> None:
        uid = int(user_id)
        self._od[uid] = (int(version), np.asarray(vals), np.asarray(idx))
        self._od.move_to_end(uid)
        while len(self._od) > self.capacity:
            self._od.popitem(last=False)
            self._m_evict.inc()
        self._m_size.set(float(len(self._od)))

    def drop(self, user_ids) -> int:
        """Invalidate specific users (user-row delta); returns # dropped."""
        n = 0
        for uid in user_ids:
            if self._od.pop(int(uid), None) is not None:
                n += 1
        self._m_inval.inc(n)
        self._m_size.set(float(len(self._od)))
        return n

    def clear(self) -> int:
        """Invalidate everything (item rows changed); returns # dropped."""
        n = len(self._od)
        self._od.clear()
        self._m_inval.inc(n)
        self._m_size.set(0.0)
        return n

    def restamp(self, version: int) -> None:
        """Mark every entry valid for ``version`` (a refresh that changed
        none of their rows)."""
        for uid, ent in self._od.items():
            self._od[uid] = (int(version),) + ent[1:]

    @property
    def hit_rate(self) -> float:
        h, m = self._m_hits.value, self._m_misses.value
        return h / (h + m) if (h + m) else 0.0
