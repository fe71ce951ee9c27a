"""Top-K ranking metrics, dense protocol (port of
``repro/training/metrics.py:11-36``): the exactness reference of the
streaming evaluator; and the CTR models' AUC (``:39-67``)."""

from __future__ import annotations

import torch

__all__ = ["recall_ndcg_at_k", "auc"]


def recall_ndcg_at_k(scores: torch.Tensor, test_pos: torch.Tensor,
                     train_mask: torch.Tensor, k: int = 20):
    """Rank all items except training positives (the paper's protocol).

    scores     : (U, I) predicted scores
    test_pos   : (U, I) bool held-out positives
    train_mask : (U, I) bool training positives (excluded from ranking)
    returns (recall@k, ndcg@k) as floats, averaged over users with at least
    one test positive. Ties rank the lowest item index first (a stable
    descending sort), as ``jax.lax.top_k`` does.
    """
    scores = scores.masked_fill(train_mask, float("-inf"))
    _, order = torch.sort(scores, dim=1, descending=True, stable=True)
    topk = order[:, :k]
    hits = torch.gather(test_pos, 1, topk).to(torch.float32)    # (U, k)
    n_test = test_pos.sum(dim=1)                                 # (U,)
    valid = n_test > 0
    recall_u = hits.sum(dim=1) / torch.clamp_min(n_test, 1)
    discounts = 1.0 / torch.log2(
        torch.arange(k, dtype=torch.float32, device=scores.device) + 2.0)
    dcg = (hits * discounts).sum(dim=1)
    ideal = (torch.arange(k, device=scores.device)[None, :]
             < n_test[:, None]).to(torch.float32)
    idcg = (ideal * discounts).sum(dim=1)
    ndcg_u = dcg / torch.clamp_min(idcg, 1e-9)
    denom = max(int(valid.sum()), 1)
    return (float(torch.where(valid, recall_u, 0.0).sum()) / denom,
            float(torch.where(valid, ndcg_u, 0.0).sum()) / denom)


def auc(logits: torch.Tensor, labels: torch.Tensor) -> float:
    """Rank-based AUC for binary CTR labels (recsys eval). Ties get AVERAGE
    ranks (the Mann-Whitney convention): a tied positive/negative pair
    contributes exactly 1/2, whatever order the sort leaves equal logits
    in."""
    n = logits.shape[0]
    sorted_x, order = torch.sort(logits)
    # tie groups over the sorted array: the mean 0-based position of each
    # run of equal values
    is_start = torch.ones(n, dtype=torch.bool, device=logits.device)
    is_start[1:] = sorted_x[1:] != sorted_x[:-1]
    group = torch.cumsum(is_start.long(), 0) - 1
    _, counts = torch.unique_consecutive(group, return_counts=True)
    ends = torch.cumsum(counts, 0)
    # positions s .. e-1 average to (s + e - 1) / 2
    mean_pos = (ends - counts + ends - 1).to(logits.dtype) / 2
    ranks = torch.empty_like(mean_pos[group])
    ranks[order] = mean_pos[group]
    n_pos = torch.sum(labels)
    n_neg = n - n_pos
    pos_rank_sum = torch.sum(torch.where(labels > 0, ranks, 0.0))
    return float((pos_rank_sum - n_pos * (n_pos - 1) / 2)
                 / torch.clamp_min(n_pos * n_neg, 1))
