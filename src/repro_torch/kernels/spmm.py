"""Weighted SPMM over a blocked-CSR layout: CUDA kernel and plain version.

Port of ``repro/kernels/spmm.py:spmm`` (TPU kernels ``_spmm_kernel`` and
``_spmm_dma_kernel``, which compute the same function). The op is
``out[v] = sum_{e=(u->v)} ew[e] * x[u]`` for the forward direction, and
``Aᵀ(g * ew)`` for ``transpose=True`` (the layout's src-sorted arrays run
through the same kernel). ``ew=None`` aggregates unweighted.

The kernel is ``csrc/spmm.cu``: one CTA per destination tile, each output
element one sequential sum in slot order, no atomics, so two runs give the
same bits. Its source note says what bounds it on the H100.

``kernels.ops.spmm`` sends CUDA tensors to ``spmm_cuda`` and CPU tensors to
``spmm_plain``. The two sum in different orders, so they agree to fp32
reassociation, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import backend

__all__ = ["spmm_plain", "spmm_cuda"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P)


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
    for name in ("gat_blk", "ldst_blk", "perm_blk", "tile_ptr"):
        backend.check_cuda(getattr(dr, name),
                           torch.int32, 1 if name == "tile_ptr" else 2, name)
    if dr.gat_blk.device != x.device:
        raise ValueError(f"layout is on {dr.gat_blk.device}, x on {x.device}")
    d = x.shape[1]
    out = torch.empty((dr.n_out, d), dtype=torch.float32, device=x.device)
    fn = backend.kernel_fn("spmm", "spmm_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        backend.launch(fn, x.data_ptr(), d,
                       None if ew is None else ew.data_ptr(), m.n_edges,
                       dr.gat_blk.data_ptr(), dr.ldst_blk.data_ptr(),
                       dr.perm_blk.data_ptr(), dr.tile_ptr.data_ptr(),
                       dr.n_tiles, m.block_e, m.block_rows, dr.n_out,
                       out.data_ptr(), backend.stream_of(x))
    backend.count_launch("spmm")
    return out

