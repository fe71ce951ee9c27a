"""Architecture registry of the port (KGAT only so far)."""

from __future__ import annotations

from .base import ArchSpec, ShapeSpec
from .kgnn_paper import KGAT

__all__ = ["ARCHS", "get", "ArchSpec", "ShapeSpec"]

ARCHS = {a.name: a for a in (KGAT,)}


def get(name: str) -> ArchSpec:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(ARCHS)}") from None
