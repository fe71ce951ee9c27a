"""Activation-memory accounting (paper Table 5 "Act Mem" column; port of
``repro/core/memory.py``: ``activation_bytes_report`` and
``publish_activation_report``).

Prices the **recorded residuals**: while a loss runs under an
``ActContext``, every compressed op records the residual it saves (scope,
shape, bits, exact-mask flag: ``SavedResidual``), and this module prices
those records. The figure is analytic (what the compressed ops hold for the
backward pass), not a reading of the allocator: on the card
``torch.cuda.max_memory_allocated`` also counts the attention's
uncompressed temporaries, which are not ACT sites in the reference either.
The reference prices a ``jax.eval_shape`` trace of the loss
(``traced_activation_report``); the port prices the records of a real step
(``ActContext.report``), which are the same residuals.
"""

from __future__ import annotations

from typing import Sequence

from .quant import act_bytes

__all__ = ["activation_bytes_report", "publish_activation_report"]


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


def publish_activation_report(report: dict[str, float]) -> None:
    """Mirror an activation-bytes report into the process's metrics
    registry: per-scope rows become ``act/bytes{scope=...}`` gauges, the
    three aggregates ``act/total_bytes``, ``act/total_fp32_bytes`` and
    ``act/compression_ratio`` (the run summary carries them)."""
    from repro_torch.obs import get_registry

    reg = get_registry()
    for scope, b in report.items():
        if scope in ("total_bytes", "total_fp32_bytes", "compression_ratio"):
            reg.gauge(f"act/{scope}").set(float(b))
        else:
            reg.gauge("act/bytes", scope=scope).set(float(b))
