"""Reduced configs for CPU runs (port of the gnn and kgnn branches of
``repro/configs/smoke.py``): same topology, tiny widths."""

from __future__ import annotations

import dataclasses

from .base import ArchSpec

__all__ = ["reduced"]


def reduced(arch: ArchSpec) -> ArchSpec:
    if arch.family == "gnn":
        small = dataclasses.replace(arch.model_cfg, d_in=32, d_hidden=16,
                                    n_classes=7)
        return dataclasses.replace(arch, model_cfg=small)
    if arch.family != "kgnn":
        raise ValueError(f"the port has no reduced config for {arch.family}")
    small = dataclasses.replace(arch.model_cfg, n_users=40, n_entities=80,
                                n_relations=10, dim=16, n_layers=2)
    return dataclasses.replace(arch, model_cfg=small)
