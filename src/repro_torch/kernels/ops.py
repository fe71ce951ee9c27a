"""Device dispatch over the hand-written kernels (port of
``repro/kernels/ops.py``).

The one routing rule of the port lives here: a CUDA tensor goes to the
kernel, a CPU tensor to the kernel's plain PyTorch version, anything else
raises. There is no fallback from one to the other; a kernel that cannot
build or launch raises. ``LAUNCH_COUNTS`` (the counterpart of the JAX
package's trace-time ``TRACE_COUNTS``) counts real kernel launches by name:
``quant_pack``, ``spmm``, ``segment_sum``, ``topk_score``, ``sddmm``,
``dequant_sddmm``, ``dequant_matmul``, ``coarse_topm`` and
``dequant_unpack``, one per C entry point call (several CUDA kernels may run
per call, and ``segment_sum`` makes one call per level; see ``backend``).
``quantize(x, seed, *, bits, stochastic)`` is ``core.quant.quantize``: the
``quant_pack`` route wrapped into a ``QTensor``; ``dequantize(q)`` is its
inverse on the ``dequant_unpack`` route (the counterpart of
``repro/kernels/ops.py:dequantize``), and ``dequantize_rows(q, idx)`` the
same for the rows ``idx`` only, gathered inside the kernel.

Every call, on either route, runs inside ``obs.cost.kernel``: a traced step
(``launch.roofline.trace_step``) counts the kernel's work by its module's
cost function (``quant_pack_cost``, ``spmm_cost``, ...) and none of the
plain version's aten ops.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.quant import QTensor, quantize
from repro_torch.obs import cost as _cost

from . import dequant_matmul as _dqmm
from . import quant_pack as _qp
from . import spmm as _spmm
from . import topk_score as _tk
from .backend import LAUNCH_COUNTS

__all__ = ["quant_pack", "quantize", "dequantize", "dequantize_rows", "spmm",
           "segment_sum", "spmm_grad_ew", "dequant_matmul", "topk",
           "coarse_topm", "LAUNCH_COUNTS"]


def _on_card(x: torch.Tensor, op: str) -> bool:
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{op} runs on cuda or cpu, not {x.device}")
    return False


def quant_pack(x: torch.Tensor, seed: int, *, bits: int,
               stochastic: bool = True):
    """(rows, d) float -> (packed uint8 (rows, dp), scale (rows, 1),
    zero (rows, 1)); see kernels/quant_pack.py. On the card fp32 and bf16
    rows go to the kernel as they are (no fp32 copy of a bf16 table)."""
    with _cost.kernel("quant_pack", _qp.quant_pack_cost, *x.shape,
                      bits=bits, itemsize=x.element_size()):
        if _on_card(x, "quant_pack"):
            if x.dtype not in (torch.float32, torch.bfloat16):
                x = x.to(torch.float32)
            return _qp.quant_pack_cuda(x.contiguous(), seed, bits=bits,
                                       stochastic=stochastic)
        return _qp.quant_pack_plain(x, seed, bits=bits,
                                    stochastic=stochastic)


def dequantize(q: QTensor) -> torch.Tensor:
    """Unpack + dequantize a packed table of any leading shape:
    ``(..., dp)`` -> ``(..., dim)`` in ``q.dtype``; see
    kernels/quant_pack.py."""
    dp = q.packed.shape[-1]
    lead = q.packed.shape[:-1]
    packed = q.packed.reshape(-1, dp)
    scale = q.scale.reshape(-1, 1).to(torch.float32)
    zero = q.zero.reshape(-1, 1).to(torch.float32)
    with _cost.kernel("dequant_unpack", _qp.dequant_unpack_cost,
                      packed.shape[0], q.dim, dp):
        if _on_card(packed, "dequantize"):
            out = _qp.dequant_unpack_cuda(
                packed.contiguous(), scale.contiguous(), zero.contiguous(),
                bits=q.bits, dim=q.dim)
        else:
            out = _qp.dequant_unpack_plain(packed, scale, zero, bits=q.bits,
                                           dim=q.dim)
    return out.reshape(*lead, q.dim).to(q.dtype)


def dequantize_rows(q: QTensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows ``idx`` ((m,) int32 or int64) of a (rows, dp) packed table,
    unpacked and dequantized: ``(m, dim)`` in ``q.dtype``, equal bit for bit
    to ``dequantize(q.select(idx))``. On the card the gather runs inside
    the ``dequant_unpack`` kernel; see kernels/quant_pack.py."""
    scale = q.scale.to(torch.float32)
    zero = q.zero.to(torch.float32)
    with _cost.kernel("dequant_unpack", _qp.dequant_unpack_cost, idx.numel(),
                      q.dim, q.packed.shape[1], idx_bytes=idx.element_size()):
        if _on_card(q.packed, "dequantize_rows"):
            out = _qp.dequant_unpack_cuda(
                q.packed.contiguous(), scale.contiguous(), zero.contiguous(),
                bits=q.bits, dim=q.dim, idx=idx.contiguous())
        else:
            out = _qp.dequant_unpack_plain(q.packed, scale, zero,
                                           bits=q.bits, dim=q.dim, idx=idx)
    return out.to(q.dtype)


def spmm(x: torch.Tensor, ew: torch.Tensor | None, layout, *,
         transpose: bool = False) -> torch.Tensor:
    """Fused gather + scale + segment-accumulate over a blocked-CSR layout.

    x   : (n_src, d) float (the output gradient for ``transpose=True``)
    ew  : (E,) float edge weights in ORIGINAL edge order, or None
    returns (n_out, d), n_out = n_dst (forward) / n_src (transpose);
    see kernels/spmm.py.
    """
    with _cost.kernel("spmm", _spmm.spmm_cost, layout, math.prod(x.shape[1:]),
                      weighted=ew is not None, transpose=transpose):
        if _on_card(x, "spmm"):
            out = _spmm.spmm_cuda(x.to(torch.float32).contiguous(),
                                  None if ew is None
                                  else ew.to(torch.float32).contiguous(),
                                  layout, transpose=transpose)
            return out.to(x.dtype)
        return _spmm.spmm_plain(x, ew, layout, transpose=transpose)


def segment_sum(y: torch.Tensor, levels: tuple) -> torch.Tensor:
    """Fixed-order segment sum of the rows of ``y`` over a grouping
    (``data.csr.SegmentRuns`` levels): ``(n_rows, d)`` or ``(n_rows,)`` in,
    ``(n_out, d)`` or ``(n_out,)`` out, each output row summed in its run's
    slot order; see kernels/spmm.py."""
    with _cost.kernel("segment_sum", _spmm.segment_sum_cost, levels,
                      math.prod(y.shape[1:])):
        if _on_card(y, "segment_sum"):
            return _spmm.segment_sum_cuda(y.to(torch.float32).contiguous(),
                                          levels).to(y.dtype)
        return _spmm.segment_sum_plain(y, levels)


def spmm_grad_ew(res, g: torch.Tensor, layout) -> torch.Tensor:
    """∇ew of the SPMM: ``dew[e] = <x_hat[src_e], g[dst_e]>``, (E,) fp32 in
    original edge order. ``res`` is the saved forward residual: a packed
    ``QTensor`` (read directly, unpacked in the kernel) or the fp32
    activation; see kernels/spmm.py."""
    if isinstance(res, QTensor):
        with _cost.kernel("dequant_sddmm", _spmm.dequant_sddmm_cost, layout,
                          res.dim, res.packed.shape[1]):
            if _on_card(g, "spmm_grad_ew"):
                return _spmm.dequant_sddmm_cuda(res, g.to(torch.float32)
                                                .contiguous(), layout)
            return _spmm.dequant_sddmm_plain(res, g, layout)
    with _cost.kernel("sddmm", _spmm.sddmm_cost, layout, g.shape[1]):
        if _on_card(g, "spmm_grad_ew"):
            return _spmm.sddmm_cuda(res.to(torch.float32).contiguous(),
                                    g.to(torch.float32).contiguous(), layout)
        return _spmm.sddmm_plain(res, g, layout)


def dequant_matmul(q: QTensor, g: torch.Tensor) -> torch.Tensor:
    """``dequant(q)ᵀ @ g`` for a (rows, dp) packed table and (rows, n) g:
    the ACT weight gradient, (dim, n) fp32; see kernels/dequant_matmul.py."""
    with _cost.kernel("dequant_matmul", _dqmm.dequant_matmul_cost,
                      q.packed.shape[0], q.dim, g.shape[1], q.packed.shape[1]):
        if _on_card(g, "dequant_matmul"):
            return _dqmm.dequant_matmul_cuda(q, g.to(torch.float32)
                                             .contiguous())
        return _dqmm.dequant_matmul_plain(q, g)


# the serving calls' costs are worked out from their arguments only when a
# trace listens: the idle bracket costs a served call nothing more


def _topk_call_cost(q, items, excl, k):
    n_items, dim, dp, _ = _tk._table(items)
    return _tk.topk_cost(q.shape[0], n_items, dim, k, dp=dp or None,
                         n_excl=excl.numel())


def _coarse_call_cost(q8, items, excl, m):
    return _tk.coarse_topm_cost(q8.shape[0], items.rows, items.dim, m,
                                items.packed.shape[1], n_excl=excl.numel())


def topk(q: torch.Tensor, items, excl: torch.Tensor, *, k: int):
    """Top-``k`` of ``q @ dequant(items)ᵀ`` with per-row exclusions.

    q     : (B, d) fp32 query rows
    items : ``QTensor`` (packed rows, any bits/width) or (I, d) fp32 table
    excl  : (B, P) int32 item ids forced to -inf per row; -1 pads
    returns (values (B, k) fp32, indices (B, k) int32).
    """
    with _cost.kernel("topk_score", _topk_call_cost, q, items, excl, k):
        if _on_card(q, "topk"):
            return _tk.topk_cuda(q.to(torch.float32).contiguous(), items,
                                 excl.to(torch.int32).contiguous(), k=k)
        return _tk.topk_plain(q, items, excl.to(torch.int32), k=k)


def coarse_topm(q8: torch.Tensor, qmeta: torch.Tensor, items: QTensor,
                excl: torch.Tensor, *, m: int):
    """Top-``m`` of the coarse packed-domain scores with exclusions.

    q8    : (B, d) integer-valued fp32 query codes, qmeta (B, 2) [qs, sum q]
            (``serving.scorer.quantize_query``)
    items : ``QTensor`` packed item table
    excl  : (B, P) int32 item ids forced to -inf per row; -1 pads
    returns (values (B, m) fp32, indices (B, m) int32); see
    kernels/topk_score.py.
    """
    with _cost.kernel("coarse_topm", _coarse_call_cost, q8, items, excl, m):
        if _on_card(q8, "coarse_topm"):
            return _tk.coarse_topm_cuda(q8.contiguous(), qmeta.contiguous(),
                                        items,
                                        excl.to(torch.int32).contiguous(),
                                        m=m)
        return _tk.coarse_topm_plain(q8, qmeta, items, excl.to(torch.int32),
                                     m=m)
