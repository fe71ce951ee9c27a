"""Architecture registry of the port (the KG archs kgat, kgcn, kgin, the
GNN arch gcn-cora, the recsys archs fm, wide-deep, dlrm-mlperf and
xdeepfm, and the LM archs mistral-large-123b, codeqwen1.5-7b,
stablelm-12b, moonshot-v1-16b-a3b and grok-1-314b)."""

from __future__ import annotations

from .base import ArchSpec, ShapeSpec
from .gcn_cora import GCN_CORA
from .kgnn_paper import KGAT, KGCN, KGIN
from .lm_archs import LM_ARCHS
from .recsys_archs import DLRM_MLPERF, FM, WIDE_DEEP, XDEEPFM

__all__ = ["ARCHS", "get", "ArchSpec", "ShapeSpec"]

ARCHS = {a.name: a for a in (GCN_CORA, KGAT, KGCN, KGIN, WIDE_DEEP,
                              DLRM_MLPERF, XDEEPFM, FM) + LM_ARCHS}


def get(name: str) -> ArchSpec:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(ARCHS)}") from None
