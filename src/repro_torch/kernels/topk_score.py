"""Fused dequantize * score * top-K retrieval: CUDA kernel and plain version.

Port of ``repro/kernels/topk_score.py:_topk_kernel`` (wrapper
``fused_topk_scores``) and of the jnp chunk/merge schedule that mirrors it
(``repro/serving/scorer.py:_chunk_merge``). Scores are ``q @ x_hatᵀ`` with
``x_hat = code * scale + zero`` from a packed table, or the rows of a dense
fp32 table; per-query exclusion lists ``(B, P)`` (``-1`` pads) force listed
items to ``-inf`` before selection.

Result contract, shared by both versions: the top ``k`` of the masked score
row ordered by (value desc, index asc), which is ``jax.lax.top_k``'s tie
rule. ``torch.topk`` does not promise lowest-index ties, so the plain
version merges with a stable descending ``torch.sort``. The CUDA kernel
(``csrc/topk_score.cu``, whose note says what bounds it) selects per item
chunk and merges the chunk lists in a second pass under the same order.
Both dequantize with the same two roundings; their dot products sum in
different orders, so values agree to fp32 reassociation, and exactly when
every product and partial sum is an integer.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QTensor, unpack_bits

from . import backend

__all__ = ["topk_plain", "topk_cuda", "KERNEL_CHUNK"]

KERNEL_CHUNK = 128   # items per CTA in the CUDA kernel's first pass (>= k)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
             _P, _P, _P, _P, _P)
_NEG_INF = float("-inf")


def _chunk_merge(b, excl, k, n_items, block_i, chunk_scores, device):
    """The jnp schedule of ``scorer._chunk_merge`` in PyTorch: score a chunk,
    pad the tail chunk with -inf ghost rows, mask exclusions, merge."""
    grid = -(-n_items // block_i)
    vals = idx = None
    for c in range(grid):
        c0, c1 = c * block_i, min((c + 1) * block_i, n_items)
        s = chunk_scores(c0, c1)                          # (B, c1-c0)
        if c1 - c0 < block_i:                             # tail: ghost rows
            s = torch.nn.functional.pad(s, (0, block_i - (c1 - c0)),
                                        value=_NEG_INF)
        ids = (c0 + torch.arange(block_i, dtype=torch.int32, device=device)
               ).expand(b, block_i)
        hit = (excl[:, :, None] == ids[:, None, :]).any(dim=1)
        s = s.masked_fill(hit, _NEG_INF)
        if vals is not None:
            s = torch.cat([vals, s], dim=1)
            ids = torch.cat([idx, ids], dim=1)
        v, p = torch.sort(s, dim=1, descending=True, stable=True)
        vals, idx = v[:, :k], torch.gather(ids, 1, p[:, :k])
    return vals, idx


def topk_plain(q: torch.Tensor, items, excl: torch.Tensor, *, k: int,
               block_i: int = 1024):
    """Plain version. ``items`` is a ``QTensor`` or a dense (I, d) table."""
    q = q.to(torch.float32)
    if isinstance(items, QTensor):
        n_items = items.rows

        def chunk_scores(c0, c1):
            codes = unpack_bits(items.packed[c0:c1], items.bits,
                                items.dim).to(torch.float32)
            xhat = codes * items.scale[c0:c1] + items.zero[c0:c1]
            return q @ xhat.T
    else:
        n_items = items.shape[0]

        def chunk_scores(c0, c1):
            return q @ items[c0:c1].to(torch.float32).T
    block_i = max(min(block_i, n_items), k)
    return _chunk_merge(q.shape[0], excl, k, n_items, block_i,
                        chunk_scores, q.device)


def topk_cuda(q: torch.Tensor, items, excl: torch.Tensor, *, k: int):
    """Launch ``csrc/topk_score.cu`` (both passes)."""
    backend.check_cuda(q, torch.float32, 2, "q")
    backend.check_cuda(excl, torch.int32, 2, "excl")
    backend.require_sm90(q.device)
    B, dim = q.shape
    if excl.shape[0] != B:
        raise ValueError(f"excl has {excl.shape[0]} rows, q has {B}")
    if isinstance(items, QTensor):
        backend.check_cuda(items.packed, torch.uint8, 2, "packed")
        backend.check_cuda(items.scale, torch.float32, 2, "scale")
        backend.check_cuda(items.zero, torch.float32, 2, "zero")
        n_items, dp = items.packed.shape
        if items.dim != dim or dp * (8 // items.bits) < dim:
            raise ValueError(f"packed table of dim {items.dim} "
                             f"({dp} bytes a row) against queries of {dim}")
        ptrs = (items.packed.data_ptr(), dp, items.bits, None,
                items.scale.data_ptr(), items.zero.data_ptr())
    else:
        backend.check_cuda(items, torch.float32, 2, "items")
        n_items = items.shape[0]
        if items.shape[1] != dim:
            raise ValueError(f"items of dim {items.shape[1]} against "
                             f"queries of {dim}")
        ptrs = (None, 0, 0, items.data_ptr(), None, None)
    if not 0 < k <= min(KERNEL_CHUNK, n_items):
        raise ValueError(f"k={k} must be in [1, min({KERNEL_CHUNK}, "
                         f"n_items={n_items})]")
    n_chunks = -(-n_items // KERNEL_CHUNK)
    dev = q.device
    cand_v = torch.empty((B, n_chunks, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((B, n_chunks, k), dtype=torch.int32, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    fn = backend.kernel_fn("topk_score", "topk_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        backend.launch(fn, q.data_ptr(), B, dim, *ptrs, excl.data_ptr(),
                       excl.shape[1], n_items, k, cand_v.data_ptr(),
                       cand_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                       backend.stream_of(q))
    backend.count_launch("topk_score")
    return vals, idx

