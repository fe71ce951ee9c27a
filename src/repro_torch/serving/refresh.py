"""Incremental store refresh: delta rollout of changed rows (port of
``repro/serving/refresh.py``).

Between two rollouts of the serving tables most rows are identical; only
the entities that recent gradient steps touched move. ``store_delta``
diffs two rollouts row by row (on the packed bytes and the scale/zero bits
of quantized tables, on the fp32 bits of dense ones: bit equality is
exactly "serves identically") and packages only the changed rows;
``apply_delta`` splices them into a copy of the live store. The result is
bit-identical to the new rollout, so a delta refresh is a transfer saving,
never an approximation.

``apply_delta`` returns a new store and leaves the one it was given intact,
as the reference does: requests already being scored keep reading the old
tables. The copy costs one store's worth of device memory while both live.
The engine applies a delta on its worker thread between batches
(``serving/engine.py:refresh``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quant import QTensor

from .store import QuantizedEmbeddingStore

__all__ = ["StoreDelta", "store_delta", "apply_delta"]

_BITS_VIEW = {torch.float32: torch.int32, torch.uint8: torch.uint8}


@dataclasses.dataclass(frozen=True)
class StoreDelta:
    """Changed rows between two same-shape, same-bits store rollouts.

    ``user_rows``/``item_rows`` hold, for each changed row id, the new
    payload on the new store's device: ``(packed, scale, zero)`` for
    quantized tables, ``(rows,)`` for fp32 tables.
    """

    user_ids: np.ndarray        # (nu,) int32 changed user row ids
    item_ids: np.ndarray        # (ni,) int32 changed item row ids
    user_rows: tuple
    item_rows: tuple
    n_users: int                # identity guard: target store shape
    n_items: int
    bits: int | None

    @property
    def n_changed(self) -> int:
        return len(self.user_ids) + len(self.item_ids)

    def nbytes(self) -> int:
        """Wire cost of the delta (what a full push would multiply)."""
        return sum(a.numel() * a.element_size()
                   for part in (self.user_rows, self.item_rows)
                   for a in part)

    def stats(self) -> dict:
        return {
            "users_changed": int(len(self.user_ids)),
            "items_changed": int(len(self.item_ids)),
            "rows_changed": self.n_changed,
            "rows_total": self.n_users + self.n_items,
            "delta_bytes": self.nbytes(),
            "changed_frac": self.n_changed / max(self.n_users
                                                 + self.n_items, 1),
        }


def _table_leaves(t):
    """The per-row leaves whose bit equality defines "unchanged"."""
    if isinstance(t, QTensor):
        return (t.packed, t.scale, t.zero)
    return (t,)


def _diff_rows(old_t, new_t):
    leaves_o, leaves_n = _table_leaves(old_t), _table_leaves(new_t)
    changed = torch.zeros(leaves_n[0].shape[0], dtype=torch.bool,
                          device=leaves_n[0].device)
    for lo, ln in zip(leaves_o, leaves_n):
        view = _BITS_VIEW[ln.dtype]
        diff = lo.to(ln.device).view(view) != ln.view(view)
        changed |= diff.reshape(ln.shape[0], -1).any(dim=1)
    ids = torch.nonzero(changed)[:, 0]
    rows = tuple(ln.index_select(0, ids) for ln in leaves_n)
    return ids.to(torch.int32).cpu().numpy(), rows


def store_delta(old: QuantizedEmbeddingStore,
                new: QuantizedEmbeddingStore) -> StoreDelta:
    """Row-wise diff of two rollouts; raises on incompatible stores."""
    if old.bits != new.bits:
        raise ValueError(f"delta refresh needs matching precision: "
                         f"old bits={old.bits} new bits={new.bits} "
                         f"(a precision change is a full re-deploy)")
    if old.n_users != new.n_users or old.n_items != new.n_items or \
            old.dim != new.dim:
        raise ValueError(
            f"delta refresh needs matching table shapes: old "
            f"(U={old.n_users}, I={old.n_items}, d={old.dim}) vs new "
            f"(U={new.n_users}, I={new.n_items}, d={new.dim})")
    uids, urows = _diff_rows(old.users, new.users)
    iids, irows = _diff_rows(old.items, new.items)
    return StoreDelta(user_ids=uids, item_ids=iids, user_rows=urows,
                      item_rows=irows, n_users=old.n_users,
                      n_items=old.n_items, bits=old.bits)


def _patch(leaf: torch.Tensor, ids: np.ndarray,
           rows: torch.Tensor) -> torch.Tensor:
    out = leaf.clone()
    idx = torch.from_numpy(ids.astype(np.int64)).to(leaf.device)
    out.index_copy_(0, idx, rows.to(leaf.device))
    return out


def _patch_table(t, ids, rows):
    if len(ids) == 0:
        return t
    if isinstance(t, QTensor):
        packed, scale, zero = rows
        return dataclasses.replace(t, packed=_patch(t.packed, ids, packed),
                                   scale=_patch(t.scale, ids, scale),
                                   zero=_patch(t.zero, ids, zero))
    return _patch(t, ids, rows[0])


def apply_delta(store: QuantizedEmbeddingStore,
                delta: StoreDelta) -> QuantizedEmbeddingStore:
    """Splice changed rows into a copy; bit-identical to the rollout that
    made the delta (``apply_delta(old, store_delta(old, new)) == new``)."""
    if store.n_users != delta.n_users or store.n_items != delta.n_items \
            or store.bits != delta.bits:
        raise ValueError(
            f"delta targets (U={delta.n_users}, I={delta.n_items}, "
            f"bits={delta.bits}), store is (U={store.n_users}, "
            f"I={store.n_items}, bits={store.bits})")
    return QuantizedEmbeddingStore(
        users=_patch_table(store.users, delta.user_ids, delta.user_rows),
        items=_patch_table(store.items, delta.item_ids, delta.item_rows),
        bits=store.bits, dim=store.dim)
