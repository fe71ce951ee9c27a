"""Streaming full-ranking evaluation over the top-K scorer (port of
``repro/serving/eval.py``).

Computes the dense reference's Recall/NDCG (``training/metrics.py``) user
chunk by user chunk through ``scorer.topk_scores`` (or, with
``two_stage_c``, ``scorer.two_stage_topk``): scores stream item chunk
by item chunk, train positives are excluded through the scorer's per-user
index lists, ties keep the lowest index, and per-user recall/NDCG use the
reference formulas, summed, with the valid-user division at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from .scorer import topk_scores, two_stage_topk
from .store import QuantizedEmbeddingStore, padded_pos_lists

__all__ = ["streaming_recall_ndcg", "streaming_eval_dataset"]


def streaming_recall_ndcg(store: QuantizedEmbeddingStore,
                          train_pos: np.ndarray, test_pos: np.ndarray, *,
                          k: int = 20, user_chunk: int = 128,
                          two_stage_c: int | None = None):
    """Recall@k / NDCG@k over the full item set, streamed.

    train_pos/test_pos : (n, 2) int [user, item] pairs; users at or past
    ``store.n_users`` are ignored. Training positives are excluded from
    ranking; users with no test positive are left out of the mean.
    ``two_stage_c`` retrieves through the two-stage path (coarse scan
    keeping C·k candidates, fp32 re-rank); at ``C >= n_items / k`` it
    matches the single-stage result. Returns (recall, ndcg).
    """
    n_users = store.n_users
    train_pos = train_pos[train_pos[:, 0] < n_users]
    test_pos = test_pos[test_pos[:, 0] < n_users]
    excl = padded_pos_lists(train_pos, n_users)            # (U, P)
    test = padded_pos_lists(test_pos, n_users)             # (U, T)
    n_test = (test >= 0).sum(axis=1)                       # (U,)

    discounts = 1.0 / np.log2(np.arange(k) + 2.0)          # (k,)
    sum_recall = sum_ndcg = 0.0
    n_valid = 0
    dev = store.device
    excl_t = torch.from_numpy(excl).to(dev)
    for u0 in range(0, n_users, user_chunk):
        u1 = min(u0 + user_chunk, n_users)
        q = store.user_vectors(torch.arange(u0, u1, device=dev))
        if two_stage_c is not None:
            _, idx = two_stage_topk(q, store.items, k, c=two_stage_c,
                                    exclude=excl_t[u0:u1])
        else:
            _, idx = topk_scores(q, store.items, k, exclude=excl_t[u0:u1])
        idx = idx.cpu().numpy()                            # (B, k)
        hits = (idx[:, :, None] == test[u0:u1, None, :]).any(-1)  # (B, k)
        nt = n_test[u0:u1]
        valid = nt > 0
        recall_u = hits.sum(1) / np.maximum(nt, 1)
        dcg = (hits * discounts).sum(1)
        ideal = np.arange(k)[None, :] < nt[:, None]
        idcg = (ideal * discounts).sum(1)
        ndcg_u = dcg / np.maximum(idcg, 1e-9)
        sum_recall += float(recall_u[valid].sum())
        sum_ndcg += float(ndcg_u[valid].sum())
        n_valid += int(valid.sum())
    denom = max(n_valid, 1)
    return sum_recall / denom, sum_ndcg / denom


def streaming_eval_dataset(store: QuantizedEmbeddingStore, ds, *,
                           k: int = 20, **kw):
    """Convenience wrapper over a ``data.synthetic.KGDataset``."""
    return streaming_recall_ndcg(store, ds.train_pos, ds.test_pos, k=k, **kw)
