"""Weighted SPMM and its edge-weight gradient (SDDMM) over a blocked-CSR
layout: CUDA kernels and plain versions.

SPMM: port of ``repro/kernels/spmm.py:spmm`` (TPU kernels ``_spmm_kernel``
and ``_spmm_dma_kernel``, which compute the same function). The op is
``out[v] = sum_{e=(u->v)} ew[e] * x[u]`` for the forward direction, and
``Aᵀ(g * ew)`` for ``transpose=True`` (the layout's src-sorted arrays run
through the same kernel). ``ew=None`` aggregates unweighted.

The kernel is ``csrc/spmm.cu``: a group of lanes per output row (16 at d 64,
a warp at d 1), which finds its slots through the layout's
``row_start``/``row_end``; each output element is one sequential sum in slot
order, no atomics, so two runs give the same bits. Its source note says what
bounds it on the H100.

SDDMM: port of ``sddmm_ew`` (TPU kernel ``_sddmm_kernel``) and
``dequant_sddmm_ew`` (``_dq_sddmm_kernel`` and ``_dq_sddmm_dma_kernel``):
``dew[e] = <x_hat[src_e], g[dst_e]>`` in original edge order, from an fp32
residual or a packed ``QTensor`` (unpacked in the kernel). Both run through
``csrc/sddmm.cu`` over the slots of the forward direction (a group of lanes
per slot for fp32, one thread per slot for a packed residual), the result
written straight to ``dew[perm[slot]]``, no atomics.

``kernels.ops`` sends CUDA tensors to the ``*_cuda`` launchers and CPU
tensors to the ``*_plain`` versions. Each pair sums in different orders, so
they agree to fp32 reassociation, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QTensor, dequantize

from . import backend

__all__ = ["spmm_plain", "spmm_cuda", "sddmm_plain", "sddmm_cuda",
           "dequant_sddmm_plain", "dequant_sddmm_cuda"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _I, _P, _P, _P, _P, _P, _I, _P, _P)
_SDDMM_ARGTYPES = (_P, _I, _P, _I, _P, _P, _P, _I, _P, _P)
_DQ_SDDMM_ARGTYPES = (_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P)


def spmm_plain(x: torch.Tensor, ew: torch.Tensor | None, layout, *,
               transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version: gather, scale, ``index_add_`` per slot."""
    m = layout.meta
    dr = layout.direction(transpose)
    w = (torch.ones(m.n_edges, dtype=torch.float32, device=x.device)
         if ew is None else ew.to(torch.float32))
    # one gather puts the weights in slot order and zeroes the pad slots
    w = torch.cat([w, w.new_zeros(1)])[dr.perm_blk.reshape(-1).long()]
    rows = (dr.tile_of_blk.long()[:, None] * m.block_rows
            + dr.ldst_blk.long()).reshape(-1)
    msgs = x.to(torch.float32)[dr.gat_blk.reshape(-1).long()] * w[:, None]
    out = torch.zeros((dr.n_tiles * m.block_rows, x.shape[1]),
                      dtype=torch.float32, device=x.device)
    out.index_add_(0, rows, msgs)
    return out[:dr.n_out].to(x.dtype)


def spmm_cuda(x: torch.Tensor, ew: torch.Tensor | None, layout, *,
              transpose: bool = False) -> torch.Tensor:
    """Launch ``csrc/spmm.cu`` on one direction of the layout."""
    m = layout.meta
    dr = layout.direction(transpose)
    backend.check_cuda(x, torch.float32, 2, "x")
    backend.require_sm90(x.device)
    n_rows = m.n_dst if transpose else m.n_src
    if x.shape[0] != n_rows:
        raise ValueError(f"x has {x.shape[0]} rows, the layout gathers "
                         f"from {n_rows}")
    if ew is not None:
        backend.check_cuda(ew, torch.float32, 1, "ew")
        if ew.shape[0] != m.n_edges:
            raise ValueError(f"ew has {ew.shape[0]} entries, the layout "
                             f"has {m.n_edges} edges")
    for name in ("gat_blk", "perm_blk", "row_start", "row_end"):
        backend.check_cuda(getattr(dr, name), torch.int32,
                           2 if name.endswith("_blk") else 1, name)
    if dr.gat_blk.device != x.device:
        raise ValueError(f"layout is on {dr.gat_blk.device}, x on {x.device}")
    d = x.shape[1]
    out = torch.empty((dr.n_out, d), dtype=torch.float32, device=x.device)
    fn = backend.kernel_fn("spmm", "spmm_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        backend.launch(fn, x.data_ptr(), d,
                       None if ew is None else ew.data_ptr(),
                       dr.gat_blk.data_ptr(), dr.perm_blk.data_ptr(),
                       dr.row_start.data_ptr(), dr.row_end.data_ptr(),
                       dr.n_out, out.data_ptr(), backend.stream_of(x))
    backend.count_launch("spmm")
    return out


# -- the edge-weight gradient: SDDMM ------------------------------------------


def sddmm_plain(x: torch.Tensor, g: torch.Tensor, layout) -> torch.Tensor:
    """Plain version: gather both rows of every real slot, multiply, sum,
    and place each result at its edge."""
    m = layout.meta
    perm = layout.perm_blk.reshape(-1).long()
    real = perm < m.n_edges
    src = layout.src_blk.reshape(-1)[real].long()
    dst = layout.dstg_blk.reshape(-1)[real].long()
    vals = (x.to(torch.float32)[src] * g.to(torch.float32)[dst]).sum(dim=-1)
    out = torch.zeros(m.n_edges, dtype=torch.float32, device=x.device)
    out[perm[real]] = vals
    return out


def dequant_sddmm_plain(q: QTensor, g: torch.Tensor, layout) -> torch.Tensor:
    """Plain version from the packed residual: ``dequantize`` (the kernel's
    two roundings) then ``sddmm_plain``."""
    return sddmm_plain(dequantize(q).to(torch.float32), g, layout)


def _check_sddmm(g: torch.Tensor, layout, n_rows: int, d: int):
    m = layout.meta
    backend.check_cuda(g, torch.float32, 2, "g")
    backend.require_sm90(g.device)
    if n_rows != m.n_src or g.shape != (m.n_dst, d):
        raise ValueError(f"residual of {n_rows} rows and g of shape "
                         f"{tuple(g.shape)} against a layout of {m.n_src} "
                         f"sources and {m.n_dst} destinations, width {d}")
    for name in ("src_blk", "dstg_blk", "perm_blk"):
        arr = getattr(layout, name)
        backend.check_cuda(arr, torch.int32, 2, name)
        if arr.device != g.device:
            raise ValueError(f"layout is on {arr.device}, g on {g.device}")
    return torch.empty(m.n_edges, dtype=torch.float32, device=g.device)


def sddmm_cuda(x: torch.Tensor, g: torch.Tensor, layout) -> torch.Tensor:
    """Launch ``csrc/sddmm.cu`` on an fp32 residual."""
    backend.check_cuda(x, torch.float32, 2, "x")
    out = _check_sddmm(g, layout, x.shape[0], x.shape[1])
    m = layout.meta
    fn = backend.kernel_fn("sddmm", "sddmm_launch", _SDDMM_ARGTYPES)
    with torch.cuda.device(x.device):
        backend.launch(fn, x.data_ptr(), x.shape[1], g.data_ptr(),
                       layout.perm_blk.numel(), layout.src_blk.data_ptr(),
                       layout.dstg_blk.data_ptr(), layout.perm_blk.data_ptr(),
                       m.n_edges, out.data_ptr(), backend.stream_of(x))
    backend.count_launch("sddmm")
    return out


def dequant_sddmm_cuda(q: QTensor, g: torch.Tensor, layout) -> torch.Tensor:
    """Launch ``csrc/sddmm.cu`` on a packed residual (any bits, any width)."""
    backend.check_cuda(q.packed, torch.uint8, 2, "packed")
    backend.check_cuda(q.scale, torch.float32, 2, "scale")
    backend.check_cuda(q.zero, torch.float32, 2, "zero")
    rows, dp = q.packed.shape
    if dp * (8 // q.bits) < q.dim or q.scale.shape != (rows, 1) \
            or q.zero.shape != (rows, 1):
        raise ValueError(f"packed table {tuple(q.packed.shape)} at "
                         f"{q.bits} bits cannot hold width {q.dim}")
    out = _check_sddmm(g, layout, rows, q.dim)
    m = layout.meta
    fn = backend.kernel_fn("sddmm", "dequant_sddmm_launch",
                           _DQ_SDDMM_ARGTYPES)
    with torch.cuda.device(g.device):
        backend.launch(fn, q.packed.data_ptr(), dp, q.bits, q.dim,
                       q.scale.data_ptr(), q.zero.data_ptr(), g.data_ptr(),
                       layout.perm_blk.numel(), layout.src_blk.data_ptr(),
                       layout.dstg_blk.data_ptr(), layout.perm_blk.data_ptr(),
                       m.n_edges, out.data_ptr(), backend.stream_of(g))
    backend.count_launch("dequant_sddmm")
    return out
