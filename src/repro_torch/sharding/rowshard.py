"""Row-sharded table access on the ``model`` ranks (port of
``repro/sharding/rowshard.py``).

A row-sharded table lives as a ``(table_rows, d)`` block on each rank of a
mesh axis (global row ``i`` belongs to the rank at index
``i // table_rows``, at local offset ``i % table_rows``). The two functions
here are the only places the 2D data x model path touches such a block;
everything after them is replicated over that axis, which is the contract
their backwards rely on.

Why custom backwards instead of autograd through the collectives: every
``model`` rank computes the loss redundantly (activations are replicated
over it), so differentiating through a forward sum over the axis would
count the block gradient ``model`` times over. The backward of
``fetch_rows`` is instead a local sum of the (replicated) cotangent rows
this rank owns: its reduce-scatter share of the row gradient, with no
traffic on the axis. That sum is ``kernels.ops.segment_sum`` over a
grouping built on the host from the ids, so it adds in a fixed order (the
CUDA kernel on the card, never ``index_add_``'s atomics).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.csr import segment_runs, stable_argsort
from repro_torch.kernels import ops

from .comm import TorchMesh, psum

__all__ = ["owned_runs", "fetch_rows", "rowshard_l2"]


def owned_runs(ids, owner: int, rows_per_shard: int,
               n_valid: int | None = None, device="cpu") -> tuple:
    """The one-level grouping (``data.csr.SegmentRuns``) that sums, into
    each local row of rank ``owner``'s block, the positions of ``ids``
    that it owns (ids ``>= n_valid`` are owned by no one), in position
    order."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    own = ids // rows_per_shard == owner
    if n_valid is not None:
        own &= ids < n_valid
    pos = np.flatnonzero(own)
    off = ids[pos] - owner * rows_per_shard
    order = stable_argsort(off, rows_per_shard)
    counts = np.bincount(off, minlength=rows_per_shard)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])

    return (segment_runs(pos[order], start, start + counts, rows_per_shard,
                         len(ids), device),)


class _FetchRows(torch.autograd.Function):
    @staticmethod
    def forward(fctx, block, ok, off, runs, mesh, axis):
        fctx.runs = runs
        rows = torch.where(ok[:, None], block.index_select(0, off),
                           torch.zeros((), dtype=block.dtype,
                                       device=block.device))
        return psum(rows, mesh, axis)

    @staticmethod
    def backward(fctx, ct):
        return ops.segment_sum(ct.contiguous(), fctx.runs), \
            None, None, None, None, None


def fetch_rows(block: torch.Tensor, ids: torch.Tensor, *, mesh: TorchMesh,
               axis: str, rows_per_shard: int, n_valid: int | None = None,
               runs=None) -> torch.Tensor:
    """Gather global rows ``ids`` from a dim-0 row-sharded table.

    Forward: each rank of ``axis`` contributes the rows it owns (a masked
    local gather) and one sum over ``axis`` assembles them. Per id exactly
    one rank contributes a nonzero row, so each value is ``x + 0.0 + ...``:
    the same bits as indexing a replicated table. Ids ``>= n_valid`` come
    back as zero rows, and their cotangents are dropped, so padded block
    rows get no gradient and stay zero.

    Backward: the cotangent must be replicated over ``axis``; each rank
    sums the cotangent rows it owns into its block (``owned_runs``, given
    as ``runs`` when the ids are fixed, else built from them here)."""
    me = mesh.index(axis)
    if runs is None:
        runs = owned_runs(ids.cpu().numpy(), me, rows_per_shard, n_valid,
                          device=block.device)
    ids = ids.long()
    owner = torch.div(ids, rows_per_shard, rounding_mode="floor")
    ok = owner == me
    if n_valid is not None:
        ok &= ids < n_valid
    off = torch.where(ok, ids - owner * rows_per_shard, 0)
    return _FetchRows.apply(block, ok, off, runs, mesh, axis)


class _RowshardL2(torch.autograd.Function):
    @staticmethod
    def forward(fctx, block, mesh, axis):
        fctx.save_for_backward(block)
        return psum(torch.sum(block * block), mesh, axis)

    @staticmethod
    def backward(fctx, ct):
        (block,) = fctx.saved_tensors
        return 2.0 * block * ct, None, None


def rowshard_l2(block: torch.Tensor, *, mesh: TorchMesh, axis: str):
    """``sum(x ** 2)`` over the whole row-sharded table: the blocks' sums
    added over ``axis``, the same scalar on every rank (padded rows are
    zero). Backward ``2 * block * ct``, the full table's L2 gradient on the
    local block, under the replicated-cotangent contract of
    ``fetch_rows``."""
    return _RowshardL2.apply(block, mesh, axis)
