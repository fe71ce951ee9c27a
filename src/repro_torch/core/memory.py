"""Activation-memory accounting (paper Table 5 "Act Mem" column; port of
``repro/core/memory.py:activation_bytes_report``).

Prices the **recorded residuals**: while a loss runs under an
``ActContext``, every compressed op records the residual it saves (scope,
shape, bits, exact-mask flag: ``SavedResidual``), and this module prices
those records. The figure is analytic (what the compressed ops hold for the
backward pass), not a reading of the allocator: on the card
``torch.cuda.max_memory_allocated`` also counts the attention's
uncompressed temporaries, which are not ACT sites in the reference either.
"""

from __future__ import annotations

from typing import Sequence

from .quant import act_bytes

__all__ = ["activation_bytes_report"]


def _mask_bytes(shape: tuple[int, ...]) -> int:
    """Exact 1-bit bool mask: b/8 payload per row, no scale/zero overhead."""
    n = 1
    for s in shape:
        n *= s
    rows = n // shape[-1]
    return rows * ((shape[-1] + 7) // 8)


def activation_bytes_report(records: Sequence) -> dict[str, float]:
    """Per-scope bytes, totals, and the compression ratio against the FP32
    baseline of the same records (the paper's headline 7.1x at INT2). Each
    record carries its own storage width, so mixed schedules price right."""
    report: dict[str, float] = {}
    total = 0
    total_fp32 = 0
    for r in records:
        b = _mask_bytes(r.shape) if r.exact_mask else act_bytes(r.shape,
                                                                r.bits)
        report[r.scope] = b
        total += b
        total_fp32 += act_bytes(r.shape, None)
    report["total_bytes"] = total
    report["total_fp32_bytes"] = total_fp32
    report["compression_ratio"] = total_fp32 / max(total, 1)
    return report
