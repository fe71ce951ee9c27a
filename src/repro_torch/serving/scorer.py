"""Top-K candidate scoring over a store table (port of
``repro/serving/scorer.py``).

Never builds the ``(U, I)`` score matrix. On the card every table (packed at
any bit width, or dense fp32) goes through the fused CUDA kernel
(``kernels/topk_score.py``); on the CPU the plain chunk/merge schedule runs.
Both keep ``jax.lax.top_k``'s order: score descending, lowest index first
among ties. ``merge_topk`` merges results of separate calls on the host
under the same order.

Two-stage retrieval (``two_stage_topk``, DESIGN.md §14): a coarse scan over
all items in the packed integer-code domain (``quantize_query``'s symmetric
INT8 query against the unsigned codes, per-row affine correction; the
``coarse_topm`` kernel on the card) keeps the top ``m = min(c*k, n_items)``
candidate ids, and only those rows are dequantized (``ops.dequantize_rows``:
the ``dequant_unpack`` kernel with the row gather fused) for an fp32
re-rank. At ``c*k >= n_items`` every item is a
candidate and the ranking is the single-stage one.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.quant import QTensor
from repro_torch.kernels import ops

__all__ = ["topk_scores", "merge_topk", "two_stage_topk", "quantize_query",
           "coarse_topm"]

_NEG_INF = float("-inf")
# fl32(1 / 127): XLA compiles the reference's ``/ 127.0`` into a multiply
# by the float32 reciprocal, so ``qs`` is formed the same way here
_INV_127 = float(torch.tensor(1.0) / torch.tensor(127.0))


def _no_exclusions(b: int, device) -> torch.Tensor:
    return torch.full((b, 1), -1, dtype=torch.int32, device=device)


def topk_scores(q: torch.Tensor, items: QTensor | torch.Tensor, k: int, *,
                exclude: torch.Tensor | None = None):
    """Top-K items for a batch of query vectors against a store table.

    q       : (B, d) fp32 query rows (``store.user_vectors(...)``)
    items   : ``QTensor`` (packed store table) or fp32 ``(I, d)`` tensor
    exclude : optional (B, P) int32 per-row item-id lists (-1 pads) whose
              scores are forced to -inf before selection
    returns (values (B, k) fp32, indices (B, k) int32).
    """
    q = q.to(torch.float32)
    if exclude is None:
        exclude = _no_exclusions(q.shape[0], q.device)
    n_items = items.rows if isinstance(items, QTensor) else items.shape[0]
    if not 0 < k <= n_items:
        raise ValueError(f"k={k} must be in [1, n_items={n_items}]")
    return ops.topk(q, items, exclude.to(torch.int32), k=k)


def quantize_query(q: torch.Tensor):
    """Symmetric INT8 query codes for the coarse scan.

    Returns ``(q8, qmeta)``: ``q8`` the rounded codes as integer-valued fp32
    in [-127, 127] (``round`` is half to even, as ``jnp.round``), ``qmeta``
    (B, 2) holding per row ``[qs, sum_j q_j]`` with ``qs = max|q| / 127``.
    ``q8`` and ``qs`` are bit-identical to the reference's; the sum agrees
    to fp32 reassociation (exactly on integer-valued q).
    """
    q = q.to(torch.float32)
    qs = torch.clamp_min(q.abs().amax(dim=-1, keepdim=True), 1e-12) \
        * _INV_127
    q8 = torch.clamp(torch.round(q / qs), -127.0, 127.0)
    return q8, torch.cat([qs, q.sum(dim=-1, keepdim=True)], dim=-1)


def coarse_topm(q: torch.Tensor, items: QTensor, m: int, *,
                exclude: torch.Tensor | None = None):
    """Top-``m`` candidate ids by coarse packed-domain score.

    Returns (coarse values (B, m) fp32, indices (B, m) int32); kernel and
    plain version agree bit for bit (see kernels/topk_score.py).
    """
    if not isinstance(items, QTensor):
        raise ValueError("coarse_topm needs a packed (QTensor) item table; "
                         "fp32 stores have no packed domain to scan")
    q8, qmeta = quantize_query(q)
    if exclude is None:
        exclude = _no_exclusions(q8.shape[0], q8.device)
    if not 0 < m <= items.rows:
        raise ValueError(f"m={m} must be in [1, n_items={items.rows}]")
    return ops.coarse_topm(q8, qmeta, items, exclude, m=m)


def _rerank(q: torch.Tensor, items: QTensor, cand: torch.Tensor,
            excl: torch.Tensor, k: int):
    """fp32 dequant·score·top-k over each row's candidate rows only.

    ``cand`` (B, m) must be ascending per row: the stable sort then breaks
    ties by lowest position, which is the lowest item id, the single-stage
    contract.
    """
    b, m = cand.shape
    rows = ops.dequantize_rows(items, cand.reshape(-1))
    xhat = rows.to(torch.float32).reshape(b, m, items.dim)
    # products and a sum, not a matmul: full fp32 whatever the caller's
    # TF32 setting
    s = (xhat * q[:, None, :]).sum(dim=-1)               # (B, m)
    # re-apply exclusions: the coarse stage already set them to -inf, but
    # when m exceeds the non-excluded item count they still hold slots.
    # Ids outside [0, n_items) (other shards' items, -1 pads) never match.
    n = items.rows
    ids = excl.long()
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    banned = torch.zeros((b, n + 1), dtype=torch.bool, device=q.device)
    banned.scatter_(1, ids, True)
    s = s.masked_fill(torch.gather(banned, 1, cand.long()), _NEG_INF)
    v, p = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(cand, 1, p[:, :k])


def two_stage_topk(q: torch.Tensor, items: QTensor, k: int, *, c: int = 4,
                   exclude: torch.Tensor | None = None, stage_cb=None):
    """Two-stage retrieval: coarse packed scan -> fp32 re-rank of c·k.

    q       : (B, d) fp32 query rows
    items   : packed ``QTensor`` store table (fp32 stores use
              ``topk_scores``: there is no packed domain)
    c       : candidate multiplier; ``m = max(k, min(c*k, n_items))`` rows
              are dequantized, every other row is read only as packed codes
    stage_cb: optional ``f(stage_name, seconds)``. On the card each stage
              is timed by CUDA events on the current stream (so another
              stream's work is not counted) and only that stream's last
              event is waited for; on the CPU by the host clock
    returns (values (B, k) fp32, indices (B, k) int32).
    """
    if not isinstance(items, QTensor):
        raise ValueError("two_stage_topk needs a packed (QTensor) item "
                         "table; use topk_scores for fp32 stores")
    q = q.to(torch.float32)
    if exclude is None:
        exclude = _no_exclusions(q.shape[0], q.device)
    exclude = exclude.to(torch.int32)
    n_items = items.rows
    if not 0 < k <= n_items:
        raise ValueError(f"k={k} must be in [1, n_items={n_items}]")
    m = max(k, min(c * k, n_items))

    clock = _StageClock(q.device) if stage_cb else None
    _, cand = coarse_topm(q, items, m, exclude=exclude)
    cand = torch.sort(cand, dim=1).values
    if clock:
        clock.mark()
    out = _rerank(q, items, cand, exclude, k)
    if clock:
        clock.mark()
        for stage, dt in zip(("coarse", "rerank"), clock.seconds()):
            stage_cb(stage, dt)
    return out


class _StageClock:
    """Stage boundaries: CUDA events on the current stream, or the host
    clock on the CPU. ``seconds()`` waits for the last mark only."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self):
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def merge_topk(vals_parts, idx_parts, k: int):
    """Host-side merge of per-shard top-K results (numpy), ordered by
    (score descending, global index ascending)."""
    vals = np.concatenate([np.asarray(v) for v in vals_parts], axis=1)
    idx = np.concatenate([np.asarray(i) for i in idx_parts], axis=1)
    order = np.lexsort((idx, -vals), axis=-1)[:, :k]
    return (np.take_along_axis(vals, order, axis=1),
            np.take_along_axis(idx, order, axis=1))
