"""Top-K candidate scoring over a store table (port of
``repro/serving/scorer.py``, single stage).

Never builds the ``(U, I)`` score matrix. On the card every table (packed at
any bit width, or dense fp32) goes through the fused CUDA kernel
(``kernels/topk_score.py``); on the CPU the plain chunk/merge schedule runs.
Both keep ``jax.lax.top_k``'s order: score descending, lowest index first
among ties. ``merge_topk`` merges results of separate calls on the host
under the same order.

Two-stage retrieval (``two_stage_topk``, ``coarse_topm``,
``quantize_query``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import QTensor
from repro_torch.kernels import ops

__all__ = ["topk_scores", "merge_topk"]


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
    b = q.shape[0]
    if exclude is None:
        exclude = torch.full((b, 1), -1, dtype=torch.int32, device=q.device)
    n_items = items.rows if isinstance(items, QTensor) else items.shape[0]
    if not 0 < k <= n_items:
        raise ValueError(f"k={k} must be in [1, n_items={n_items}]")
    return ops.topk(q, items, exclude.to(torch.int32), k=k)


def merge_topk(vals_parts, idx_parts, k: int):
    """Host-side merge of per-shard top-K results (numpy), ordered by
    (score descending, global index ascending)."""
    vals = np.concatenate([np.asarray(v) for v in vals_parts], axis=1)
    idx = np.concatenate([np.asarray(i) for i in idx_parts], axis=1)
    order = np.lexsort((idx, -vals), axis=-1)[:, :k]
    return (np.take_along_axis(vals, order, axis=1),
            np.take_along_axis(idx, order, axis=1))
