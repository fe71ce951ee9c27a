"""Packed embedding store: the serving-side rollout (port of
``repro/serving/store.py``, DESIGN.md section 8).

A KGNN serves from its final user and item representations, so the serving
artifact is two row tables: one FP32 ``propagate`` over the whole CKG, users
and items sliced out of the node space, each table packed per row by the
quantizer (``core.quant.quantize``; the CUDA ``quant_pack`` kernel on the
card). Rounding is nearest by default: a store is quantized once, so the
lower-error deterministic rounding fits. ``bits=None`` keeps fp32 rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quant import QTensor, dequantize, quantize

__all__ = ["QuantizedEmbeddingStore", "build_kgnn_store", "padded_pos_lists"]


@dataclasses.dataclass(frozen=True)
class QuantizedEmbeddingStore:
    """User + item representation tables, packed for serving (``QTensor``)
    or fp32 ``(rows, d)`` tensors when ``bits`` is None."""

    users: QTensor | torch.Tensor   # (U, d)
    items: QTensor | torch.Tensor   # (I, d)
    bits: int | None
    dim: int

    @property
    def n_users(self) -> int:
        t = self.users
        return t.rows if isinstance(t, QTensor) else int(t.shape[0])

    @property
    def n_items(self) -> int:
        t = self.items
        return t.rows if isinstance(t, QTensor) else int(t.shape[0])

    @property
    def device(self) -> torch.device:
        return self.items.device

    @classmethod
    def from_arrays(cls, users: torch.Tensor, items: torch.Tensor, *,
                    bits: int | None = None, quantize_users: bool = True,
                    stochastic: bool = False,
                    seed: int = 0) -> "QuantizedEmbeddingStore":
        """Pack fp32 row tables at ``bits`` (None keeps fp32).

        Stochastic rounding draws the users' noise from ``seed`` and the
        items' from ``seed + 1``. (The JAX package derives its two seeds
        from a threefry key, so only nearest-rounded stores match it bit
        for bit.)
        """
        users = users.to(torch.float32)
        items = items.to(torch.float32)
        if users.shape[-1] != items.shape[-1]:
            raise ValueError(f"users {tuple(users.shape)} and items "
                             f"{tuple(items.shape)} differ in width")
        dim = int(items.shape[-1])
        if bits is None:
            return cls(users, items, None, dim)
        if quantize_users:
            users = quantize(users, seed, bits=bits, stochastic=stochastic)
        return cls(users=users,
                   items=quantize(items, seed + 1, bits=bits,
                                  stochastic=stochastic),
                   bits=bits, dim=dim)

    def user_vectors(self, user_ids: torch.Tensor) -> torch.Tensor:
        """Dequantized fp32 query rows for a batch of user ids."""
        ids = user_ids.long()
        if not isinstance(self.users, QTensor):
            return self.users[ids]
        return dequantize(self.users.select(ids)).to(torch.float32)

    def item_matrix(self) -> torch.Tensor:
        """The full dequantized (I, d) item table (tests and the dense
        reference; serving reads the packed table directly)."""
        if not isinstance(self.items, QTensor):
            return self.items
        return dequantize(self.items).to(torch.float32)

    def first_users(self, n: int) -> "QuantizedEmbeddingStore":
        """The store restricted to users ``[0, n)`` (same item table)."""
        u = self.users
        u = u.select(slice(0, n)) if isinstance(u, QTensor) else u[:n]
        return dataclasses.replace(self, users=u)

    def memory_report(self) -> dict:
        """Bytes ledger: packed payload + scale/zero overhead vs fp32."""
        def table_bytes(t):
            if isinstance(t, QTensor):
                return (t.packed.numel(),
                        (t.scale.numel() + t.zero.numel()) * 4, t.rows)
            return t.numel() * 4, 0, int(t.shape[0])

        up, uo, u_rows = table_bytes(self.users)
        ip, io_, i_rows = table_bytes(self.items)
        total = up + uo + ip + io_
        fp32 = (u_rows + i_rows) * self.dim * 4
        return {
            "bits": self.bits, "dim": self.dim,
            "n_users": u_rows, "n_items": i_rows,
            "packed_bytes": up + ip,
            "scale_zero_bytes": uo + io_,
            "total_bytes": total,
            "fp32_bytes": fp32,
            "compression_ratio": fp32 / total,
        }


def build_kgnn_store(params: dict, g, cfg, n_items: int, *,
                     bits: int | None = 8, stochastic: bool = False,
                     seed: int = 0) -> QuantizedEmbeddingStore:
    """Offline rollout: one FP32 ``propagate`` pass -> packed store. Only
    users and items are served; attribute entities shape the
    representations during propagation."""
    from repro_torch.models import kgnn

    reps = kgnn.propagate(params, g, cfg)
    users = reps[:cfg.n_users]
    items = reps[cfg.n_users:cfg.n_users + n_items]
    return QuantizedEmbeddingStore.from_arrays(
        users, items, bits=bits, stochastic=stochastic, seed=seed)


def padded_pos_lists(pos: np.ndarray, n_users: int, *,
                     pad: int = -1, min_width: int = 1) -> np.ndarray:
    """(n, 2) [user, item] pairs -> (U, P) per-user padded index lists.

    Row ``u`` lists user ``u``'s items in the order they appear in ``pos``
    (the JAX package's loop order), padded with ``pad``; ``P`` is the most
    positives of any user, at least ``min_width``.
    """
    pos = np.asarray(pos, np.int64).reshape(-1, 2)
    counts = np.bincount(pos[:, 0], minlength=n_users)[:n_users]
    width = max(int(counts.max(initial=0)), min_width)
    out = np.full((n_users, width), pad, np.int32)
    order = np.argsort(pos[:, 0], kind="stable")
    users = pos[order, 0]
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(users)) - first[users]
    out[users, rank] = pos[order, 1]
    return out
