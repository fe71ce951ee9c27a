"""Fused dequantize * score * top-K retrieval and the coarse top-m scan of
two-stage retrieval: CUDA kernels and plain versions.

Port of ``repro/kernels/topk_score.py:_topk_kernel`` (wrapper
``fused_topk_scores``) and ``_coarse_kernel`` (wrapper
``fused_coarse_topm``), and of the jnp chunk/merge schedule that mirrors
them (``repro/serving/scorer.py:_chunk_merge``, ``_coarse_jnp``). Scores
are ``q @ x_hatᵀ`` with ``x_hat = code * scale + zero`` from a packed table,
or the rows of a dense fp32 table; per-query exclusion lists ``(B, P)``
(``-1`` pads) force listed items to ``-inf`` before selection.

Result contract, shared by both versions: the top ``k`` of the masked score
row ordered by (value desc, index asc), which is ``jax.lax.top_k``'s tie
rule. ``torch.topk`` does not promise lowest-index ties, so the plain
version merges with a stable descending ``torch.sort``. The CUDA kernel
(``csrc/topk_score.cu``, whose note says what bounds it) selects per item
chunk and merges the chunk lists in rounds under the same order
(``csrc/topk_select.cuh``), for any ``k <= n_items``. Both dequantize with
the same two roundings; their dot products sum in different orders, so
values agree to fp32 reassociation, and exactly when every product and
partial sum is an integer.

The coarse scan scores ``dot * (qs * scale) + sum_q * zero`` with ``dot =
q8 . codes`` integer-valued (exact in fp32 while ``127 * (2^bits - 1) * d <
2^24``) and the three products and the sum rounded apart, in that order, in
both versions (``csrc/coarse_topm.cu``): kernel and plain version agree bit
for bit on any input.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QTensor, unpack_bits

from . import backend

__all__ = ["topk_plain", "topk_cuda", "coarse_topm_plain", "coarse_topm_cuda"]

KERNEL_CHUNK = 128   # items per CTA in the CUDA kernels' first pass
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
             _P, _P, _P, _P, _P, _P, _P)
_COARSE_ARGTYPES = (_P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I,
                    _P, _P, _P, _P, _P, _P, _P)
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


def coarse_topm_plain(q8: torch.Tensor, qmeta: torch.Tensor, items: QTensor,
                      excl: torch.Tensor, *, m: int, block_i: int = 1024):
    """Plain version of the coarse scan (``scorer._coarse_jnp``'s schedule):
    per chunk ``dot * (qs * scale_t) + sum_q * zero_t``, the products and
    the sum rounded apart, then the shared mask and merge."""
    n_items = items.rows
    qs, sum_q = qmeta[:, 0:1], qmeta[:, 1:2]

    def chunk_scores(c0, c1):
        codes = unpack_bits(items.packed[c0:c1], items.bits,
                            items.dim).to(torch.float32)
        dot = q8 @ codes.T                 # integer-valued fp32: exact
        return (dot * (qs * items.scale[c0:c1].T)
                + sum_q * items.zero[c0:c1].T)

    block_i = max(min(block_i, n_items), m)
    return _chunk_merge(q8.shape[0], excl, m, n_items, block_i,
                        chunk_scores, q8.device)


def _check_packed(items: QTensor, dim: int) -> int:
    backend.check_cuda(items.packed, torch.uint8, 2, "packed")
    backend.check_cuda(items.scale, torch.float32, 2, "scale")
    backend.check_cuda(items.zero, torch.float32, 2, "zero")
    n_items, dp = items.packed.shape
    if items.dim != dim or dp * (8 // items.bits) < dim:
        raise ValueError(f"packed table of dim {items.dim} "
                         f"({dp} bytes a row) against queries of {dim}")
    return n_items


def _outputs(b: int, n_items: int, m: int, dev):
    """(B, m) values and indices, and the two candidate buffers of the
    kernels' merge rounds (each chunk keeps its top min(m, KERNEL_CHUNK))."""
    shape = (b, -(-n_items // KERNEL_CHUNK) * min(m, KERNEL_CHUNK))
    scratch = [torch.empty(shape, dtype=dt, device=dev)
               for _ in range(2) for dt in (torch.float32, torch.int32)]
    return (torch.empty((b, m), dtype=torch.float32, device=dev),
            torch.empty((b, m), dtype=torch.int32, device=dev), scratch)


def topk_cuda(q: torch.Tensor, items, excl: torch.Tensor, *, k: int):
    """Launch ``csrc/topk_score.cu`` (chunk lists, then the merge rounds)."""
    backend.check_cuda(q, torch.float32, 2, "q")
    backend.check_cuda(excl, torch.int32, 2, "excl")
    backend.require_sm90(q.device)
    B, dim = q.shape
    if excl.shape[0] != B:
        raise ValueError(f"excl has {excl.shape[0]} rows, q has {B}")
    if isinstance(items, QTensor):
        n_items = _check_packed(items, dim)
        ptrs = (items.packed.data_ptr(), items.packed.shape[1], items.bits,
                None, items.scale.data_ptr(), items.zero.data_ptr())
    else:
        backend.check_cuda(items, torch.float32, 2, "items")
        n_items = items.shape[0]
        if items.shape[1] != dim:
            raise ValueError(f"items of dim {items.shape[1]} against "
                             f"queries of {dim}")
        ptrs = (None, 0, 0, items.data_ptr(), None, None)
    if not 0 < k <= n_items:
        raise ValueError(f"k={k} must be in [1, n_items={n_items}]")
    vals, idx, scratch = _outputs(B, n_items, k, q.device)
    fn = backend.kernel_fn("topk_score", "topk_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        backend.launch(fn, q.data_ptr(), B, dim, *ptrs, excl.data_ptr(),
                       excl.shape[1], n_items, k,
                       *(t.data_ptr() for t in scratch), vals.data_ptr(),
                       idx.data_ptr(), backend.stream_of(q))
    backend.count_launch("topk_score")
    return vals, idx


def coarse_topm_cuda(q8: torch.Tensor, qmeta: torch.Tensor, items: QTensor,
                     excl: torch.Tensor, *, m: int):
    """Launch ``csrc/coarse_topm.cu`` (chunk lists, then the merge rounds)."""
    backend.check_cuda(q8, torch.float32, 2, "q8")
    backend.check_cuda(qmeta, torch.float32, 2, "qmeta")
    backend.check_cuda(excl, torch.int32, 2, "excl")
    backend.require_sm90(q8.device)
    B, dim = q8.shape
    if qmeta.shape != (B, 2) or excl.shape[0] != B:
        raise ValueError(f"qmeta {tuple(qmeta.shape)} and excl "
                         f"{tuple(excl.shape)} do not fit {B} queries")
    if not isinstance(items, QTensor):
        raise ValueError("the coarse scan needs a packed (QTensor) table")
    n_items = _check_packed(items, dim)
    if 127 * (2**items.bits - 1) * dim >= 2**24:
        raise ValueError(f"d={dim} at {items.bits} bits: the integer dot "
                         f"would pass 2^24 and stop being exact in fp32")
    if not 0 < m <= n_items:
        raise ValueError(f"m={m} must be in [1, n_items={n_items}]")
    vals, idx, scratch = _outputs(B, n_items, m, q8.device)
    fn = backend.kernel_fn("coarse_topm", "coarse_topm_launch",
                           _COARSE_ARGTYPES)
    with torch.cuda.device(q8.device):
        backend.launch(fn, q8.data_ptr(), qmeta.data_ptr(), B, dim,
                       items.packed.data_ptr(), items.packed.shape[1],
                       items.bits, items.scale.data_ptr(),
                       items.zero.data_ptr(), excl.data_ptr(), excl.shape[1],
                       n_items, m, *(t.data_ptr() for t in scratch),
                       vals.data_ptr(), idx.data_ptr(),
                       backend.stream_of(q8))
    backend.count_launch("coarse_topm")
    return vals, idx
