"""Fanout neighbour sampler (GraphSAGE-style) for the GCN's ``minibatch_lg``
path (port of ``repro/data/sampler.py``).

Host-side numpy over a CSR adjacency, the reference's calls in the
reference's order, so a seeded ``np.random.Generator`` gives the same
blocks bit for bit. Each hop emits a block of static size (padded with the
frontier's own ids):

  block h: src set  = frontier ∪ sampled neighbours   (n_dst * (fanout+1))
           edges    = (local_src -> local_dst)
  outermost block first; features are gathered for the outermost src set.

``block_layouts`` gives each block its blocked-CSR layout
(``data.csr.build_spmm_layout``), which the SPMM kernel aggregates over.
"""

from __future__ import annotations

import numpy as np

from .csr import build_spmm_layout, stable_argsort

__all__ = ["build_csr", "sample_blocks", "block_layouts"]


def build_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """CSR over incoming edges: for each dst node, its src neighbours.
    ``stable_argsort`` is ``np.argsort(kind="stable")``'s permutation, by
    radix passes."""
    order = stable_argsort(dst, n_nodes)
    src_sorted = src[order]
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, src_sorted


def sample_blocks(indptr: np.ndarray, indices: np.ndarray,
                  seeds: np.ndarray, fanouts: list[int], *,
                  rng: np.random.Generator):
    """Returns ``(blocks, input_nodes)``; ``blocks[0]`` is the outermost
    hop, ``fanouts[0]`` the hop next to the seeds.

    Each block dict: ``src``, ``dst`` (int32 local edge endpoints),
    ``n_src``, ``n_dst`` (static), plus ``src_nodes``/``dst_nodes`` global
    id arrays (the src set padded by cycling the frontier's ids, which are
    members of the next hop's node set)."""
    blocks = []
    frontier = seeds.astype(np.int64)
    for fanout in fanouts:
        n_dst = len(frontier)
        # `fanout` in-neighbours per frontier node, with replacement;
        # isolated nodes self-loop
        deg = indptr[frontier + 1] - indptr[frontier]
        offs = rng.integers(0, np.maximum(deg, 1)[:, None],
                            (n_dst, fanout))
        if len(indices):
            nbr = indices[np.minimum(indptr[frontier, None] + offs,
                                     len(indices) - 1)]
        else:   # no edges: every node self-loops; nothing to gather
            nbr = np.zeros((n_dst, fanout), indices.dtype)
        nbr = np.where(deg[:, None] > 0, nbr, frontier[:, None])
        src_nodes = np.concatenate([frontier, nbr.reshape(-1)])
        uniq, inv = np.unique(src_nodes, return_inverse=True)
        n_src_static = n_dst * (fanout + 1)
        pad = n_src_static - len(uniq)
        src_nodes_padded = np.concatenate(
            [uniq, np.resize(frontier, pad) if pad else
             np.empty(0, np.int64)])
        # neighbour j of frontier node i -> edge (local(nbr), i); plus self
        loc_nbr = inv[n_dst:].reshape(n_dst, fanout)
        loc_self = inv[:n_dst]
        e_src = np.concatenate([loc_self, loc_nbr.reshape(-1)])
        e_dst = np.concatenate([np.arange(n_dst),
                                np.repeat(np.arange(n_dst), fanout)])
        blocks.append({
            "src": e_src.astype(np.int32),
            "dst": e_dst.astype(np.int32),
            "n_src": n_src_static,
            "n_dst": n_dst,
            "src_nodes": src_nodes_padded,
            "dst_nodes": frontier.copy(),
        })
        frontier = src_nodes_padded
    blocks.reverse()  # outermost hop first (as gcn_forward_blocks takes them)
    return blocks, frontier


def block_layouts(blocks: list, device="cuda") -> list:
    """The blocked-CSR layout of each block (``sample_blocks``' order),
    built on the host, its arrays on ``device``."""
    return [build_spmm_layout(b["src"], b["dst"], n_dst=b["n_dst"],
                              n_src=b["n_src"], device=device)
            for b in blocks]
