"""Architecture + shape specs (port of ``repro/configs/base.py``): the specs
and the LM, GNN and recsys families' shapes, ``LM_SHAPES``, ``GNN_SHAPES``
and ``RECSYS_SHAPES``, with the reference's numbers."""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ShapeSpec", "ArchSpec", "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # kgnn_train | full_graph | minibatch | batched_graphs
    #                  | train | prefill | decode | serve | retrieval
    params: tuple    # sorted (key, value) pairs, hashable

    def p(self) -> dict:
        return dict(self.params)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str      # kgnn | gnn | recsys | lm | moe_lm
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


LM_SHAPES = (
    _s("train_4k", "train", seq_len=4096, global_batch=256),
    _s("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    _s("decode_32k", "decode", seq_len=32768, global_batch=128),
    _s("long_500k", "decode", seq_len=524288, global_batch=1),
)

GNN_SHAPES = (
    _s("full_graph_sm", "full_graph", n_nodes=2708, n_edges=10556,
       d_feat=1433, n_classes=7),
    _s("minibatch_lg", "minibatch", n_nodes=232965, n_edges=114615892,
       batch_nodes=1024, fanouts=(15, 10)),
    _s("ogb_products", "full_graph", n_nodes=2449029, n_edges=61859140,
       d_feat=100, n_classes=47),
    _s("molecule", "batched_graphs", n_nodes=30, n_edges=64, batch=128),
)

RECSYS_SHAPES = (
    _s("train_batch", "train", batch=65536),
    _s("serve_p99", "serve", batch=512),
    _s("serve_bulk", "serve", batch=262144),
    _s("retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000),
)
