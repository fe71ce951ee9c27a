"""KG-aware neighbour-sampled minibatches with blocked-CSR hop layouts (port
of ``repro/data/minibatch.py``).

The full-graph step holds the whole entity table and edge set on the card.
This module lets every KG model train on graphs that do not fit
(DESIGN.md section 11):

  * ``build_kg_csr``: a one-time host CSR over incoming edges, relation ids
    alongside;
  * ``sample_kg_blocks``: per-hop fanout sampling into
    ``models.kgnn.BlockView`` bipartite blocks of static padded shapes. Each
    hop's destination frontier is the leading prefix of its source frontier
    (the seeds-prefix invariant), so block-local indices are also positions
    into the outermost gathered table, and the seed rows are the first
    ``n_seeds`` rows of every layer's output;
  * every block carries its blocked-CSR layout (``data.csr`` with
    ``pad_static=True``) and its grouping by relation
    (``data.csr.relation_runs``), both built here on the host, so the
    kernels run on a block as on the full graph;
  * ``MinibatchStream``: a background thread (``training.trainer.
    PrefetchIterator``) that pairs BPR batches with sampled blocks, so the
    host's sampling and layout building overlap the card's step. The
    blocks' tensors stay on the host (pinned with ``pin=True``); the
    training thread moves them to the card (``SampledGraphView.to``).

The numpy calls are the JAX package's, in the same order, so a seed gives
identical arrays. Sampling: per destination, ``fanout`` incoming edges are
drawn with replacement when the in-degree exceeds the fanout, and taken
exactly (without replacement, the remainder masked) otherwise, so a fanout
at least the largest in-degree keeps the whole neighbourhood.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.data.csr import build_spmm_layout, group_ids, \
    map_tensors, relation_runs, stable_argsort
from repro_torch.models.kgnn import BlockView, SampledGraphView

__all__ = ["KGAdjacency", "build_kg_csr", "sample_kg_blocks",
           "SampledItem", "sampled_items", "MinibatchStream",
           "parse_fanouts"]


@dataclasses.dataclass(frozen=True)
class KGAdjacency:
    """CSR over incoming edges: for each destination its (src, rel)
    pairs."""

    indptr: np.ndarray    # (n_nodes + 1,) int64
    src: np.ndarray       # (E,) int64 source node per slot, dst-sorted
    rel: np.ndarray       # (E,) int64 relation id per slot
    n_nodes: int
    n_relations: int

    @property
    def max_in_degree(self) -> int:
        return int(np.max(self.indptr[1:] - self.indptr[:-1], initial=0))


def build_kg_csr(src, dst, rel, n_nodes: int,
                 n_relations: int) -> KGAdjacency:
    """Host-side CSR over incoming edges (relation ids alongside)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    rel = np.asarray(rel, np.int64)
    order = stable_argsort(dst, n_nodes)
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return KGAdjacency(indptr=indptr, src=src[order], rel=rel[order],
                       n_nodes=n_nodes, n_relations=int(n_relations))


def parse_fanouts(spec: str) -> tuple[int, ...]:
    """``"fanout=15,10"`` or ``"15,10"`` -> ``(15, 10)``."""
    body = spec.split("=", 1)[1] if "=" in spec else spec
    try:
        fanouts = tuple(int(x) for x in body.split(",") if x)
        if not fanouts or any(f < 1 for f in fanouts):
            raise ValueError
    except ValueError:
        raise ValueError(
            f"--sample expects fanout=F1,F2,... (one positive fanout per "
            f"layer, seed-adjacent hop first), got {spec!r}") from None
    return fanouts


def _one_hop(adj: KGAdjacency, frontier: np.ndarray, fanout: int,
             rng: np.random.Generator):
    """Sample one hop: (nbr, rel, mask), each (n_dst, fanout)."""
    n_dst = len(frontier)
    deg = adj.indptr[frontier + 1] - adj.indptr[frontier]
    ar = np.arange(fanout)[None, :]
    # always draw, so the stream does not depend on the degrees
    drawn = rng.integers(0, np.maximum(deg, 1)[:, None], (n_dst, fanout))
    exact = deg[:, None] <= fanout
    offs = np.where(exact, np.minimum(ar, np.maximum(deg - 1, 0)[:, None]),
                    drawn)
    mask = np.where(exact, ar < deg[:, None], True)
    if len(adj.src):
        e_ix = np.minimum(adj.indptr[frontier][:, None] + offs,
                          len(adj.src) - 1)
        nbr = adj.src[e_ix]
        rel = adj.rel[e_ix]
    else:   # no edges: every slot is masked (deg 0); nothing to gather
        nbr = np.zeros((n_dst, fanout), adj.src.dtype)
        rel = np.zeros((n_dst, fanout), adj.rel.dtype)
    # a masked slot is a weight-0 self edge: its endpoint must be in the
    # next frontier, and the destination's own id always is
    nbr = np.where(mask, nbr, frontier[:, None])
    rel = np.where(mask, rel, 0)
    return nbr, rel, mask


def _extend_frontier(frontier: np.ndarray, nbr: np.ndarray,
                     mask: np.ndarray, fanout: int,
                     n_nodes: int) -> np.ndarray:
    """The next frontier ``[frontier | new unique neighbours | pad]`` of
    static length ``len(frontier) * (fanout + 1)``; the order-preserving
    dedup keeps the seeds-prefix invariant, the pads cycle frontier ids.
    (The reference's ``np.isin`` and ``np.unique``, by table lookups and
    linear-time sorts over the ``n_nodes`` ids: the same arrays.)"""
    cand = nbr.reshape(-1)[mask.reshape(-1)]
    member = np.zeros(n_nodes, bool)
    member[frontier] = True
    cand = cand[~member[cand]]
    first = group_ids(cand, n_nodes)[1]
    new = cand[np.sort(first)]
    n_src = len(frontier) * (fanout + 1)
    pad = n_src - len(frontier) - len(new)
    return np.concatenate([frontier, new, np.resize(frontier, pad)]) \
        if pad else np.concatenate([frontier, new])


def sample_kg_blocks(adj: KGAdjacency, seeds: np.ndarray,
                     fanouts: tuple[int, ...], *,
                     rng: np.random.Generator, pin: bool = False):
    """Sample ``len(fanouts)`` hops outward from ``seeds``.

    Returns ``(view, input_nodes, requests)``: a ``SampledGraphView`` whose
    blocks are in execution order (outermost hop first, what layer 0
    reads), the outermost frontier's global node ids (the rows the tier
    store gathers), and the row-access stream with multiplicity (the seeds
    and every real edge draw: what the store's LFU counts and hit rate are
    measured over). ``fanouts`` are listed seed-outward: ``fanouts[0]`` is
    the hop next to the seeds, which the last layer reads. The blocks'
    tensors are on the host, in pinned memory with ``pin=True``.
    """
    seeds = np.asarray(seeds, np.int64)
    if seeds.ndim != 1 or not len(seeds):
        raise ValueError(f"seeds must be a non-empty 1-D id array, "
                         f"got shape {seeds.shape}")
    if seeds.min() < 0 or seeds.max() >= adj.n_nodes:
        raise ValueError(
            f"seed ids outside [0, {adj.n_nodes}): "
            f"[{seeds.min()}, {seeds.max()}]")

    def t(a, dtype):
        x = torch.from_numpy(np.ascontiguousarray(a, dtype))
        return x.pin_memory() if pin else x

    blocks = []
    requests = [seeds]
    frontier = seeds
    for fanout in fanouts:
        n_dst = len(frontier)
        nbr, rel, mask = _one_hop(adj, frontier, fanout, rng)
        requests.append(nbr.reshape(-1)[mask.reshape(-1)])
        nxt = _extend_frontier(frontier, nbr, mask, fanout, adj.n_nodes)
        # the first position of every id in nxt
        uq, first_pos = group_ids(nxt, adj.n_nodes)[:2]
        pos = np.empty(adj.n_nodes, np.int64)
        pos[uq] = first_pos
        e_src = pos[nbr.reshape(-1)]
        e_dst = np.repeat(np.arange(n_dst, dtype=np.int64), fanout)
        rel = rel.reshape(-1)
        layout = build_spmm_layout(
            e_src, e_dst, n_dst=n_dst, n_src=len(nxt), pad_static=True,
            device="cpu")
        runs = relation_runs(rel, adj.n_relations, device="cpu")
        if pin:
            layout, runs = map_tensors((layout, runs),
                                       torch.Tensor.pin_memory)
        blocks.append(BlockView(
            src=t(e_src, np.int32), dst=t(e_dst, np.int32),
            rel=t(rel, np.int32), mask=t(mask.reshape(-1), np.float32),
            layout=layout, rel_runs=runs, n_src=len(nxt), n_dst=n_dst))
        frontier = nxt
    blocks.reverse()   # outermost hop first: layer 0's
    return (SampledGraphView(blocks=tuple(blocks), n_seeds=len(seeds)),
            frontier, np.concatenate(requests))


# -- streaming loader ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SampledItem:
    """One prepared minibatch: blocks and the rows the tier store must
    gather. Seeds are packed ``[user nodes | pos item nodes | neg item
    nodes]``, a third each (``models.kgnn.sampled_bpr_loss``)."""

    view: SampledGraphView
    input_nodes: np.ndarray    # (n_input_rows,) global node ids
    requests: np.ndarray       # row-access stream with multiplicity
    batch: dict                # the BPR batch (user/pos/neg)
    index: int                 # stream position


def sampled_items(ds, fanouts: tuple[int, ...], *, batch_size: int,
                  seed: int = 0, pin: bool = False) -> Iterator[SampledItem]:
    """Infinite deterministic stream of ``SampledItem``s of a ``KGDataset``:
    BPR batches and blocks come from generators seeded by ``seed``, so a
    stream replays exactly."""
    from repro_torch.data.synthetic import bpr_batches

    adj = build_kg_csr(ds.src, ds.dst, ds.rel, ds.n_nodes, ds.n_relations)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xB10C]))
    for i, batch in enumerate(bpr_batches(ds, batch_size, seed=seed)):
        seeds = np.concatenate([
            batch["user"].astype(np.int64),
            ds.n_users + batch["pos"].astype(np.int64),
            ds.n_users + batch["neg"].astype(np.int64)])
        view, input_nodes, requests = sample_kg_blocks(
            adj, seeds, fanouts, rng=rng, pin=pin)
        yield SampledItem(view=view, input_nodes=input_nodes,
                          requests=requests, batch=batch, index=i)


class MinibatchStream:
    """``sampled_items`` on a background thread with a bounded queue and a
    clean shutdown (``PrefetchIterator``), so sampling and layout building
    overlap the card's step."""

    def __init__(self, ds, fanouts: tuple[int, ...], *, batch_size: int,
                 seed: int = 0, pin: bool = False):
        from repro_torch.training.trainer import PrefetchIterator

        self.fanouts = tuple(fanouts)
        self._pf = PrefetchIterator(
            sampled_items(ds, self.fanouts, batch_size=batch_size,
                          seed=seed, pin=pin),
            depth=2, timeout_s=120.0)

    def next(self) -> SampledItem:
        return self._pf.next()

    def close(self) -> None:
        self._pf.close()

    def __enter__(self) -> "MinibatchStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
