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
version merges with a stable descending ``torch.sort``. The CUDA kernels
(``csrc/topk_score.cu``, ``csrc/coarse_topm.cu``, whose notes say what
bounds them) share one schedule and selection (``csrc/topk_select.cuh``):
a persistent scan keeps each query's running top ``min(k, 128)`` per run
of item tiles, then one CTA per query row merges the runs' lists (``k <=
128``), or merge rounds take any ``k <= n_items``. The C launcher picks the
query tile, the grid and the route from (B, n_items, k); the wrapper reads
that plan (:func:`plan_for`, the kernel's ``*_plan`` entry) only to
allocate the scratch. Both versions dequantize with the same two roundings;
their dot products sum in different orders, so values agree to fp32
reassociation, and exactly when every product and partial sum is an
integer.

The coarse scan scores ``dot * (qs * scale) + sum_q * zero`` with ``dot =
q8 . codes`` integer-valued (exact in fp32 while ``127 * (2^bits - 1) * d <
2^24``; an s32 tensor-core sum in the kernel) and the three products and
the sum rounded apart, in that order, in both versions: kernel and plain
version agree bit for bit on any input.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.quant import QTensor, unpack_bits

from . import backend

__all__ = ["topk_plain", "topk_cuda", "coarse_topm_plain", "coarse_topm_cuda",
           "plan_for", "Plan"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
             _L, _P, _P, _P)
_COARSE_ARGTYPES = (_P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                    _P, _P, _L, _P, _P, _P)
_PLAN_ARGTYPES = (_I,) * 7 + (_P,)
_ENTRY = {False: ("topk_score", "topk"), True: ("coarse_topm", "coarse_topm")}
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


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the CUDA kernels run one call, as their planner
    (``make_plan`` in ``csrc/topk_select.cuh``) says: query tile ``qt``,
    ``grid`` scan CTAs, ``slots`` lists of ``list_len`` a query row,
    ``n_buffers`` scratch buffers of ``scratch_bytes`` each, ``n_kernels``
    CUDA launches a call. ``route`` is "threshold" (k <= 128: the scan, then
    the row merge where ``slots`` > 1) or "rounds" (k > 128: merge rounds)."""
    qt: int
    grid: int
    slots: int
    list_len: int
    scratch_bytes: int
    n_buffers: int
    n_kernels: int

    @property
    def route(self) -> str:
        return "rounds" if self.n_buffers == 2 else "threshold"


@functools.lru_cache(maxsize=1024)
def _plan(coarse: bool, index: int, b: int, n_items: int, m: int, dim: int,
          dp: int, bits: int, qt: int) -> Plan:
    lib, entry = _ENTRY[coarse]
    fn = backend.kernel_fn(lib, f"{entry}_plan", _PLAN_ARGTYPES)
    out = (ctypes.c_longlong * 7)()
    with torch.cuda.device(index):
        backend.launch(fn, b, n_items, m, dim, dp, bits, qt,
                       ctypes.addressof(out))
    return Plan(*out)


def _table(items):
    """(n_items, dim, dp, bits) of a packed table; dp and bits 0 for a
    dense one."""
    if isinstance(items, QTensor):
        return items.rows, items.dim, items.packed.shape[1], items.bits
    return items.shape[0], items.shape[1], 0, 0


def plan_for(b: int, items, m: int, *, device, coarse: bool = False,
             qt: int = 0) -> Plan:
    """The plan of a call of B queries against ``items`` (a ``QTensor`` or
    a dense table) keeping the top m on ``device``, at query tile ``qt``
    (0: the kernel picks it by B)."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    n_items, dim, dp, bits = _table(items)
    return _plan(coarse, index, b, n_items, m, dim, dp, bits, qt)


def _outputs(b: int, items, m: int, dev, qt: int, *, coarse: bool):
    """(B, m) values and indices, the plan's scratch buffers (the caller
    holds them until the launch), their two pointers (None where the plan
    needs fewer) and their size in bytes."""
    p = plan_for(b, items, m, device=dev, coarse=coarse, qt=qt)
    bufs = [torch.empty(p.scratch_bytes, dtype=torch.uint8, device=dev)
            for _ in range(p.n_buffers)]
    ptrs = [t.data_ptr() for t in bufs] + [None] * (2 - len(bufs))
    return (torch.empty((b, m), dtype=torch.float32, device=dev),
            torch.empty((b, m), dtype=torch.int32, device=dev), bufs, ptrs,
            p.scratch_bytes)


def topk_cuda(q: torch.Tensor, items, excl: torch.Tensor, *, k: int):
    """Launch ``csrc/topk_score.cu``; its launcher picks the query tile."""
    return _topk_cuda(q, items, excl, k, 0)


def _topk_cuda(q, items, excl, k: int, qt: int):
    """:func:`topk_cuda` at query tile ``qt`` (0: picked by B)."""
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
    vals, idx, bufs, cand, n_bytes = _outputs(B, items, k, q.device, qt,
                                              coarse=False)
    fn = backend.kernel_fn("topk_score", "topk_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        backend.launch(fn, q.data_ptr(), B, dim, *ptrs, excl.data_ptr(),
                       excl.shape[1], n_items, k, qt, *cand, n_bytes,
                       vals.data_ptr(), idx.data_ptr(), backend.stream_of(q))
    backend.count_launch("topk_score")
    return vals, idx


def coarse_topm_cuda(q8: torch.Tensor, qmeta: torch.Tensor, items: QTensor,
                     excl: torch.Tensor, *, m: int):
    """Launch ``csrc/coarse_topm.cu``; its launcher picks the query
    tile."""
    return _coarse_topm_cuda(q8, qmeta, items, excl, m, 0)


def _coarse_topm_cuda(q8, qmeta, items, excl, m: int, qt: int):
    """:func:`coarse_topm_cuda` at query tile ``qt`` (0: picked by B)."""
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
    vals, idx, bufs, cand, n_bytes = _outputs(B, items, m, q8.device, qt,
                                              coarse=True)
    fn = backend.kernel_fn("coarse_topm", "coarse_topm_launch",
                           _COARSE_ARGTYPES)
    with torch.cuda.device(q8.device):
        backend.launch(fn, q8.data_ptr(), qmeta.data_ptr(), B, dim,
                       items.packed.data_ptr(), items.packed.shape[1],
                       items.bits, items.scale.data_ptr(),
                       items.zero.data_ptr(), excl.data_ptr(), excl.shape[1],
                       n_items, m, qt, *cand, n_bytes, vals.data_ptr(),
                       idx.data_ptr(), backend.stream_of(q8))
    backend.count_launch("coarse_topm")
    return vals, idx
