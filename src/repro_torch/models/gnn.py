"""GCN (Kipf & Welling, arXiv:1609.02907), arch ``gcn-cora`` (port of
``repro/models/gnn.py``).

Three regimes, as in the reference:
  * full graph     (``full_graph_sm`` / ``ogb_products``): propagate over
                   every node (``gcn_forward``);
  * sampled        (``minibatch_lg``): fanout blocks from
                   ``data.sampler`` (``gcn_forward_blocks``);
  * batched graphs (``molecule``): block-diagonal edges and a mean readout
                   per graph (``gcn_forward_batched``).

The symmetric normalisation D^-1/2 A D^-1/2 is folded into node scalings
around an unweighted ``act_spmm``, exact because the aggregation is linear:
only the transforms' inputs are compressed (``gcn/layer<l>/dense``), and
ReLU keeps its 1-bit mask (``gcn/layer<l>/relu``). The aggregation runs the
SPMM kernel over the graph's blocked-CSR layout in both directions; the
in-degrees are the layout's exact integer run lengths. The graph readout
sums each graph's rows in a fixed order (``core.act.sum_rows`` over
``data.csr.segment_runs``), never with ``index_add_``'s atomics.

Parameters come from a seeded ``torch.Generator`` (``init_params``) or the
reference's, carried across as numpy arrays (``params_from_jax``).
``gcn_forward_spmd`` is not ported (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.act import act_matmul, act_relu, act_spmm, sum_rows
from repro_torch.core.context import model_context
from repro_torch.data.csr import segment_runs, stable_argsort
from repro_torch.kernels.backend import full_fp32, resolve_device

from .layers import glorot

__all__ = ["GCNConfig", "init_params", "params_from_jax", "sym_norm",
           "gcn_forward", "gcn_forward_blocks", "gcn_forward_batched",
           "readout_runs", "node_xent"]


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    """The reference's config less the fields no ported code reads: the
    aggregation is always the paper's mean with symmetric normalisation,
    and ``compressed_gather`` belongs to the unported sharded forward."""

    n_layers: int = 2
    d_in: int = 1433        # cora features
    d_hidden: int = 16
    n_classes: int = 7
    # Â(XW) == (ÂX)W: when d_in > d_out, transform before aggregating, so
    # the SPMM moves the narrow side
    transform_first: bool = True


def init_params(cfg: GCNConfig, *, seed: int = 0, device="cuda") -> dict:
    """``{"w": [W_0, ..., W_{L-1}]}``, Glorot-uniform from a seeded CPU
    ``torch.Generator``, moved to ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"w": [glorot(gen, (a, b)).to(dev)
                  for a, b in zip(dims[:-1], dims[1:])]}


def params_from_jax(params_np: dict, device="cuda") -> dict:
    """Carry the reference's ``{"w": [...]}``, given as numpy arrays,
    across."""
    dev = resolve_device(device)
    return {"w": [torch.from_numpy(np.array(w, np.float32)).to(dev)
                  for w in params_np["w"]]}


def sym_norm(layout, dtype=torch.float32) -> torch.Tensor:
    """(n_dst,) ``rsqrt(max(deg, 1))`` from the layout's exact integer
    in-degrees."""
    return torch.rsqrt(torch.clamp_min(layout.in_degree().to(dtype), 1.0))


def gcn_forward(params: dict, x: torch.Tensor, layout, *,
                cfg: GCNConfig) -> torch.Tensor:
    """Full-batch GCN, Z = Â ... σ(Â X W0) W1, over ``layout`` (the
    blocked-CSR layout of the edge list, self loops included; ``n_src ==
    n_dst`` = the node count). The sites resolve from the ambient
    ``ActContext`` (FP32 without one) at ``gcn/layer<l>/{dense,relu}``."""
    ctx = model_context()
    ctx.check_key("gcn_forward")
    h = x
    with full_fp32(), ctx, ctx.scope("gcn"):
        dinv = sym_norm(layout, x.dtype)[:, None]
        for l, w in enumerate(params["w"]):
            with ctx.scope(f"layer{l}"):
                pre = cfg.transform_first and w.shape[0] > w.shape[1]
                if pre:  # (ÂX)W == Â(XW): aggregate the narrow side
                    h = act_matmul(h, w, scope="dense")
                h = h * dinv
                h = act_spmm(h, None, layout, scope="agg")
                h = h * dinv
                if not pre:
                    h = act_matmul(h, w, scope="dense")
                if l < len(params["w"]) - 1:
                    h = act_relu(h, scope="relu")
    return h


def gcn_forward_blocks(params: dict, x: torch.Tensor, layouts: list, *,
                       cfg: GCNConfig) -> torch.Tensor:
    """Sampled-minibatch GCN over fanout blocks, outermost hop first: one
    layout a block (``data.sampler.block_layouts``), its ``n_src`` rows
    the previous block's ``n_dst``; ``x`` holds the outermost src set's
    features. Each layer averages over the block's edges (its exact
    in-degrees), then transforms, at ``gcn_blocks/layer<l>/...``."""
    ctx = model_context()
    ctx.check_key("gcn_forward_blocks")
    h = x
    with full_fp32(), ctx, ctx.scope("gcn_blocks"):
        for l, (w, layout) in enumerate(zip(params["w"], layouts)):
            with ctx.scope(f"layer{l}"):
                deg = layout.in_degree().to(h.dtype)
                agg = act_spmm(h, None, layout, scope="agg")
                h = agg / torch.clamp_min(deg, 1.0)[:, None]
                h = act_matmul(h, w, scope="dense")
                if l < len(params["w"]) - 1:
                    h = act_relu(h, scope="relu")
    return h


def readout_runs(graph_ids, n_graphs: int, device="cuda") -> tuple:
    """The one-level grouping of node rows by graph id (numpy ids in
    ``[0, n_graphs)``) that ``gcn_forward_batched`` sums over: each
    graph's rows in row order."""
    ids = np.asarray(graph_ids, dtype=np.int64)
    counts = np.bincount(ids, minlength=n_graphs)[:n_graphs]
    end = np.cumsum(counts)
    return (segment_runs(stable_argsort(ids, n_graphs), end - counts, end,
                         n_graphs, len(ids), resolve_device(device)),)


def gcn_forward_batched(params: dict, x: torch.Tensor, layout,
                        graph_ids: torch.Tensor, runs: tuple, *,
                        cfg: GCNConfig) -> torch.Tensor:
    """Batched small graphs (molecule): ``gcn_forward`` over the
    block-diagonal ``layout``, then the mean of each graph's node logits.
    ``runs`` is ``readout_runs(graph_ids, ...)``: the sum runs in its fixed
    order (``sum_rows``), its backward is the gather by ``graph_ids``."""
    node_logits = gcn_forward(params, x, layout, cfg=cfg)
    level = runs[-1]
    with full_fp32():
        pooled = sum_rows(node_logits, graph_ids.long(), runs)
        counts = (level.row_end - level.row_start).to(x.dtype)
        return pooled / torch.clamp_min(counts, 1.0)[:, None]


def node_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's mean cross-entropy, ``-mean(sum(one_hot(y) *
    log_softmax(logits), -1))``: each row's sum holds one nonzero term, so
    it is that term, gathered (no (N, C) one-hot on the card)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(logp.gather(1, labels.long()[:, None]))
