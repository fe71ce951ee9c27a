"""Architecture + shape specs (port of ``repro/configs/base.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ShapeSpec", "ArchSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # e.g. kgnn_train
    params: tuple    # sorted (key, value) pairs, hashable

    def p(self) -> dict:
        return dict(self.params)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str      # kgnn
    model_cfg: Any
    shapes: tuple
    source: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name}; "
                       f"have {[s.name for s in self.shapes]}")


def _s(name, kind, **kw) -> ShapeSpec:
    return ShapeSpec(name, kind, tuple(sorted(kw.items())))
