"""Knowledge-graph neural recommenders over a collaborative knowledge graph
(port of ``repro/models/kgnn.py``, the single-device full-graph and
neighbour-sampled paths): KGAT, KGCN (KGNN-LS), KGIN and R-GCN, for the
FP32 serving rollout and activation-compressed training.

Users, items and attribute entities share one node space; user-item
interactions are the ``interact`` relation, merged with the item KG. Each
model computes its per-edge weighting once from the layer-0 embeddings
(``_edge_weights``: KGAT's attention, KGCN's relation-scored softmax,
KGIN's intent-weighted relation table; R-GCN has none), then runs
``n_layers`` layers and a readout (concat for KGAT, sum for the others).

KGAT's attention uses the basis-decomposed relation projection
``W_r = sum_b a_rb V_b`` (DESIGN.md section 3), softmaxed over each
destination's edges; each layer aggregates with the SPMM kernel over the
graph's blocked-CSR layout and applies the bi-interaction aggregator. KGCN
aggregates with the same ACT SPMM, then a dense layer (sigmoid, tanh on the
last layer). KGIN sums ``e[src] * r[rel]`` by destination and divides by
the in-degree. R-GCN's messages ``sum_b coef[rel, b] * (e V_b)[src]`` are
four SPMMs, one per basis, with the gathered coefficients as edge weights.

The layers run on a graph view. The full graph is a ``CKG``: every layer
aggregates over its edges, into all of its rows. A sampled minibatch is a
``SampledGraphView`` of per-hop bipartite ``BlockView``s, outermost hop
first (``data.minibatch``): layer ``l`` reads the ``n_src`` rows of its
block's source frontier and writes the ``n_dst`` rows of its destination
frontier, which is their prefix (the seeds-prefix invariant), so block
indices are positions into the layer-0 table too and the per-hop edge
weights come from the layer-0 embeddings, as on the full graph. Masked
slots (``mask == 0``) are weight-0 edges: their logits are ``-1e30``, their
weights and messages are multiplied by the mask, and KGIN's and R-GCN's
degree is the mask summed by destination. The readout keeps the seed rows
of every layer (``sampled_reps``).

On several ranks (``training.data_parallel``) each ``data`` rank runs the
same layers on one shard of the edges, split by destination: a
``ShardGraphView`` (``Shard2DGraphView`` when the entity table is stored as
row blocks across the ``model`` ranks). Its sources index the shard's
halo, the unique rows it reads, which ``table`` brings in from every rank
(a tiled all-gather, then the halo's rows); its destinations are the
shard's own rows (``local_rows``), and ``unshard`` gathers the readout for
the BPR scores (``kg_shard_loss``, ``kg_shard_reps``). The layers reach
every difference between these views through the same hooks (the view's
``layer_graph``, ``local_rows``, ``seed_rows``, ``unshard`` and
``param_l2``; the layer graph's ``table``, ``mask_logits``,
``mask_weights``, ``mask_messages`` and ``edge_ones``), each the identity
on the full graph.

The ACT sites of each layer (``model_sites``; ``spmm``, ``w1`` ... under
``<model>/layer<l>/``) resolve their policy and seed from the ambient
``ActContext``: ``bpr_loss`` runs them under the training schedule,
``propagate`` under FP32 with autograd off. The edge weights, KGIN's
aggregation and R-GCN's SPMMs are no ACT sites, as in the reference:
autograd keeps their tensors uncompressed.

A training step gives the same bits every run, on the card too. The SPMM
kernel sums each destination in slot order, and the edge-softmax
denominators are that same kernel run over a ones column (their ∇ew the
SDDMM kernel on the same column). Every gather (``gather_rows``)
backpropagates through a fixed-order segment sum over the graph's groupings
of the edges: by destination and by source (the layout's slot runs) and by
relation (``CKG.rel_runs``), where ``index_select``'s own backward,
``index_add_``, adds with atomics on the card; KGIN's sum by destination is
that segment sum (``sum_rows``). The edge softmax's max (``scatter_reduce``)
does not depend on order, and ``score_pairs``' batch gathers backpropagate
through a sort-based ``index_put_``, which is deterministic on the card.
Every matmul runs in full fp32: ``forward_reps`` and the training step
switch TF32 off for their own span (``kernels.backend.full_fp32``) and
restore the caller's setting.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.act import act_matmul, act_nonlin, act_spmm, \
    gather_rows, sum_rows, weighted_spmm
from repro_torch.core.context import act_context, model_context
from repro_torch.core.policy import FP32
from repro_torch.data.csr import attach_layout, to_device
from repro_torch.kernels import ops
from repro_torch.kernels.backend import full_fp32, resolve_device

from .layers import glorot, normal_init, param_leaves

__all__ = ["KGNNConfig", "CKG", "BlockView", "SampledGraphView",
           "ShardGraphView", "Shard2DGraphView", "MODELS",
           "model_sites", "segment_softmax", "kgat_bi_interaction",
           "init_params", "params_from_jax", "propagate_view",
           "forward_reps", "propagate", "readout", "score_pairs", "bpr_loss",
           "sampled_reps", "sampled_bpr_loss", "kg_shard_loss",
           "kg_shard_reps"]

MODELS = ("kgat", "kgcn", "kgin", "rgcn")


class _ViewHooks:
    """The hooks the layers call on a view and on its layer graphs, each
    the identity here (the full graph; the sampled view overrides the
    view hooks, a block and a shard the edge hooks). A layer graph's
    ``mask`` is None when every edge is real."""

    # -- the view: which graph each layer runs on, which rows it keeps ------

    def check_depth(self, n_layers: int) -> None:
        pass

    def layer_graph(self, layer: int):
        return self

    def local_rows(self, table):
        """This view's rows of the entity parameter (its layer-0 input)."""
        return table

    def seed_rows(self, e):
        """The rows of a layer output that the readout keeps."""
        return e

    def unshard(self, x):
        """The readout rows of every node from this view's rows."""
        return x

    def param_l2(self, params: dict):
        """The L2 of every parameter, the same scalar on every rank."""
        return sum(torch.sum(x ** 2) for x in param_leaves(params))

    # -- a layer graph: where its sources come from, its pad slots ----------

    def input_rows(self, e):
        """The rows of a layer input its edges read (a block reads a prefix
        of a wider table)."""
        return e

    def table(self, x, axis: int = 0):
        """The table the sources index (``n_src`` rows along ``axis``),
        from this graph's rows of ``x``."""
        return x

    def tables(self, xs: list) -> list:
        """``table`` of several same-shaped inputs."""
        return xs

    def mask_logits(self, logits):
        return logits if self.mask is None else \
            torch.where(self.mask > 0, logits, -1e30)

    def mask_weights(self, w):
        return w if self.mask is None else w * self.mask

    def mask_messages(self, m):
        return m if self.mask is None else m * self.mask[:, None]

    def edge_ones(self, dtype):
        return (torch.ones(self.src.shape, dtype=dtype, device=self.src.device)
                if self.mask is None else self.mask.to(dtype))


@dataclasses.dataclass(frozen=True)
class CKG(_ViewHooks):
    """Collaborative knowledge graph in COO form (inverse edges included),
    always with its blocked-CSR ``layout`` and its grouping of the edges by
    relation (``rel_runs``, ``data.csr.relation_runs``) on the same
    device."""

    src: torch.Tensor  # (E,) int32 node ids
    dst: torch.Tensor  # (E,) int32 node ids
    rel: torch.Tensor  # (E,) int32 relation ids
    n_nodes: int
    n_relations: int
    layout: object = None
    rel_runs: tuple = None
    mask = None          # every edge is real

    @property
    def n_src(self) -> int:
        return self.n_nodes

    @property
    def n_dst(self) -> int:
        return self.n_nodes

    @classmethod
    def build(cls, src, dst, rel, *, n_nodes: int, n_relations: int,
              device="cuda", block_e: int = 256,
              block_rows: int = 256) -> "CKG":
        dev = resolve_device(device)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

        g = cls(t(src), t(dst), t(rel), int(n_nodes), int(n_relations))
        return attach_layout(g, block_e=block_e, block_rows=block_rows)


@dataclasses.dataclass(frozen=True)
class BlockView(_ViewHooks):
    """One sampled fanout hop: a bipartite edge block (port of
    ``repro/models/kgnn.py:BlockView``), built on the host by
    ``data.minibatch.sample_kg_blocks``. ``src`` indexes the layer's input
    table (``n_src`` rows), ``dst`` its first ``n_dst`` rows; ``mask`` is 1
    for a sampled edge and 0 for a pad slot. ``layout`` is the block's
    blocked-CSR layout (``pad_static``) and ``rel_runs`` its grouping by
    relation (``data.csr.relation_runs``)."""

    src: torch.Tensor     # (Eb,) int32 block-local source row
    dst: torch.Tensor     # (Eb,) int32 block-local destination row
    rel: torch.Tensor     # (Eb,) int32 relation ids
    mask: torch.Tensor    # (Eb,) float32 1 = sampled edge, 0 = pad
    layout: object
    rel_runs: tuple
    n_src: int
    n_dst: int

    def input_rows(self, e):
        return e[:self.n_src] if e.shape[0] > self.n_src else e

    def to(self, device) -> "BlockView":
        return dataclasses.replace(
            self, layout=to_device(self.layout, device),
            rel_runs=to_device(self.rel_runs, device),
            **{k: getattr(self, k).to(device, non_blocking=True)
               for k in ("src", "dst", "rel", "mask")})


@dataclasses.dataclass(frozen=True)
class SampledGraphView(_ViewHooks):
    """A neighbour-sampled minibatch: one ``BlockView`` per layer,
    outermost hop first; the innermost hop's destinations are the
    ``n_seeds`` seeds. The entity table the model is given is the gathered
    outermost frontier (``n_input_rows`` rows; ``training.tiering``)."""

    blocks: tuple
    n_seeds: int

    @property
    def n_input_rows(self) -> int:
        return self.blocks[0].n_src

    def check_depth(self, n_layers: int) -> None:
        if len(self.blocks) != n_layers:
            raise ValueError(f"the model has {n_layers} layers, the view "
                             f"{len(self.blocks)} blocks")

    def layer_graph(self, layer: int):
        return self.blocks[layer]

    def seed_rows(self, e):
        return e[:self.n_seeds]

    def to(self, device) -> "SampledGraphView":
        return dataclasses.replace(
            self, blocks=tuple(b.to(device) for b in self.blocks))


@dataclasses.dataclass(frozen=True)
class ShardGraphView(_ViewHooks):
    """One ``data`` rank's shard of a graph split by destination (port of
    ``repro/models/kgnn.py:ShardGraphView``), on the rank's device; it is
    also the graph of every layer. Built by ``training.data_parallel``
    from one row of a ``data.csr.EdgePartition`` and its layout
    (``data.csr.shard_graph_arrays``): ``src`` indexes the ``h_cap`` rows
    ``table`` returns (every rank's rows gathered, then the shard's
    ``halo``), ``dst`` the shard's ``num_rows`` rows, pad edges carry
    ``mask == 0``. ``local_rows`` cuts this rank's rows out of a
    replicated node table (zero-padded to ``n_nodes_padded``)."""

    src: torch.Tensor       # (Ec,) int32 halo-local source row
    dst: torch.Tensor       # (Ec,) int32 shard-local destination row
    rel: torch.Tensor       # (Ec,) int32 relation ids
    mask: torch.Tensor      # (Ec,) float32 1 = real edge, 0 = pad
    layout: object
    rel_runs: tuple
    halo: torch.Tensor      # (Hc,) int32 unique global sources (pads 0)
    halo_count: int         # real halo rows
    mesh: object            # sharding.comm.TorchMesh
    axis: str               # the data axis
    num_rows: int           # rows per shard
    n_nodes_padded: int     # num_rows * data ranks

    @property
    def n_src(self) -> int:
        return int(self.halo.shape[0])

    @property
    def n_dst(self) -> int:
        return self.num_rows

    def local_rows(self, table):
        pad = self.n_nodes_padded - table.shape[0]
        if pad:
            table = torch.cat([table, table.new_zeros((pad,)
                                                      + table.shape[1:])])
        i = self.mesh.index(self.axis)
        return table[i * self.num_rows:(i + 1) * self.num_rows]

    def table(self, x, axis: int = 0):
        from repro_torch.sharding.comm import all_gather

        full = all_gather(x, self.mesh, self.axis, dim=axis)
        return _HaloRows.apply(full, self.halo, self.halo_count, axis)

    def tables(self, xs: list) -> list:
        return list(self.table(torch.stack(xs, dim=1)).unbind(1))

    def unshard(self, x):
        from repro_torch.sharding.comm import all_gather

        return all_gather(x, self.mesh, self.axis, dim=0)


class _HaloRows(torch.autograd.Function):
    """``full.index_select(dim, halo)``; backward copies the real halo rows'
    cotangents into a zero table (the real halo ids are unique, so no
    order of additions is involved; the pad rows repeat id 0 and only pad
    edges, whose cotangents are zero, read them)."""

    @staticmethod
    def forward(fctx, full, halo, count, dim):
        fctx.shape, fctx.dim = full.shape, dim
        fctx.save_for_backward(halo[:count])
        return full.index_select(dim, halo)

    @staticmethod
    def backward(fctx, g):
        (real,) = fctx.saved_tensors
        out = g.new_zeros(fctx.shape)
        out.index_copy_(fctx.dim, real.long(),
                        g.narrow(fctx.dim, 0, real.shape[0]))
        return out, None, None, None


@dataclasses.dataclass(frozen=True)
class Shard2DGraphView(ShardGraphView):
    """A ``ShardGraphView`` whose entity table is stored as row blocks
    across the ``model`` ranks (port of
    ``repro/models/kgnn.py:Shard2DGraphView``; the 2D data x model mesh).
    Only two hooks differ from the 1D view:

      * ``local_rows``: the shard's rows are the contiguous global ids
        ``[s * num_rows, (s + 1) * num_rows)``; ``sharding.rowshard.
        fetch_rows`` assembles them from the blocks with one sum over the
        ``model`` ranks, one real row plus zeros each, so the same bits as
        slicing a replicated table, and everything after it is the 1D
        computation;
      * ``param_l2``: the row-sharded tables add through
        ``rowshard_l2`` (the blocks' sums added over ``model``).

    Everything after the fetch is replicated over ``model``; the backwards
    of both functions rely on that."""

    model_axis: str = "model"
    table_rows: int = 0      # block rows a model rank holds
    n_valid_rows: int = 0    # real node count; padded ids fetch as zero
    row_sharded: tuple = ()  # top-level parameter names stored as blocks
    local_runs: tuple = ()   # fetch_rows' backward grouping of local_ids

    def local_ids(self) -> torch.Tensor:
        s = self.mesh.index(self.axis)
        return torch.arange(s * self.num_rows, (s + 1) * self.num_rows,
                            device=self.dst.device)

    def local_rows(self, table):
        from repro_torch.sharding.rowshard import fetch_rows

        return fetch_rows(table, self.local_ids(), mesh=self.mesh,
                          axis=self.model_axis,
                          rows_per_shard=self.table_rows,
                          n_valid=self.n_valid_rows,
                          runs=self.local_runs or None)

    def param_l2(self, params: dict):
        from repro_torch.sharding.rowshard import rowshard_l2

        total = 0.0
        for name, sub in params.items():
            if name in self.row_sharded:
                total = total + rowshard_l2(sub, mesh=self.mesh,
                                            axis=self.model_axis)
            else:
                total = total + sum(torch.sum(x ** 2) for x in
                                    (sub if isinstance(sub, list)
                                     else [sub]))
        return total


@dataclasses.dataclass(frozen=True)
class KGNNConfig:
    model: str = "kgat"          # kgat | kgcn | kgin | rgcn
    n_users: int = 0
    n_entities: int = 0          # items + attribute entities
    n_relations: int = 0         # incl. `interact`, both directions
    dim: int = 64                # embedding size (paper fixes 64)
    n_layers: int = 3            # paper fixes 3
    layer_dims: tuple = ()       # per-layer out dims; default = dim each
    n_intents: int = 4           # KGIN
    n_bases: int = 4             # KGAT attention / R-GCN bases
    l2: float = 1e-5             # L2 weight of bpr_loss
    readout: str = "concat"      # concat (KGAT) | sum (the others) | last

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_entities

    @property
    def dims(self) -> tuple:
        return self.layer_dims or (self.dim,) * self.n_layers


def model_sites(cfg: KGNNConfig) -> tuple[tuple[str, str], ...]:
    """Per-layer ``(site_name, op_kind)`` table of a model's ACT sites."""
    if cfg.model == "kgat":
        return (("spmm", "spmm"), ("w1", "matmul"), ("w2", "matmul"),
                ("act1", "nonlin"), ("act2", "nonlin"))
    if cfg.model == "kgcn":
        return (("spmm", "spmm"), ("dense", "matmul"), ("act", "nonlin"))
    if cfg.model == "kgin":
        return (("act", "nonlin"),)
    if cfg.model == "rgcn":
        return tuple((f"basis{b}", "matmul") for b in range(cfg.n_bases)) \
            + (("self", "matmul"), ("act", "nonlin"))
    raise ValueError(f"unknown KG model {cfg.model!r}; have {MODELS}")


def segment_softmax(logits: torch.Tensor, g) -> torch.Tensor:
    """Numerically stable softmax of per-edge logits over each destination
    of a graph or block ``g``; a masked slot's logit is ``-1e30`` and its
    weight is multiplied by the mask (0).

    The max is ``scatter_reduce(amax)`` (order-free) and carries no
    gradient: the softmax does not depend on the shift, so its derivative
    through the max is zero. The denominators are the SPMM of a ones column
    with the exponentials as edge weights, summed in the layout's dst-sorted
    slot order, deterministically; their ∇ew (``g_den[dst_e]``) is the SDDMM
    of the same column. That SPMM is no ACT site and records nothing. The
    gather of the denominators back to the edges sums its gradient over the
    destination runs (``gather_rows``).
    """
    seg = g.dst.long()
    logits = g.mask_logits(logits)
    mx = torch.full((g.n_dst,), float("-inf"), dtype=logits.dtype,
                    device=logits.device)
    mx = mx.scatter_reduce(0, seg, logits.detach(), reduce="amax",
                           include_self=True)
    ex = torch.exp(logits - mx.index_select(0, seg))
    ones = torch.ones((g.n_src, 1), dtype=ex.dtype, device=ex.device)
    den = weighted_spmm(ones, ex, g.layout)[:, 0]
    w = ex / (gather_rows(den, seg, g.layout.runs()) + 1e-16)
    return g.mask_weights(w)


def init_params(cfg: KGNNConfig, *, seed: int = 0, device="cuda") -> dict:
    """The parameters of ``cfg.model`` from a seeded CPU
    ``torch.Generator``, moved to ``device`` (the same seed gives the same
    values on every device)."""
    model_sites(cfg)                                  # names the model
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d = cfg.dim
    dims = (d,) + cfg.dims
    pairs = list(zip(dims[:-1], dims[1:]))
    p = {
        "entity": normal_init(gen, (cfg.n_nodes, d), 0.1),
        "relation": normal_init(gen, (cfg.n_relations, d), 0.1),
    }
    if cfg.model == "kgat":
        p["att_basis"] = normal_init(gen, (cfg.n_bases, d, d), 0.1)
        p["att_coef"] = normal_init(gen, (cfg.n_relations, cfg.n_bases), 0.1)
        p["w1"] = [glorot(gen, s) for s in pairs]
        p["w2"] = [glorot(gen, s) for s in pairs]
    elif cfg.model == "kgcn":
        p["w"] = [glorot(gen, s) for s in pairs]
        p["b"] = [torch.zeros((b,)) for _, b in pairs]
    elif cfg.model == "kgin":
        p["intent"] = normal_init(gen, (cfg.n_intents, cfg.n_relations), 0.1)
    else:                                             # rgcn
        p["basis"] = normal_init(gen, (cfg.n_bases, d, d), 0.1)
        p["coef"] = normal_init(gen, (cfg.n_relations, cfg.n_bases), 0.1)
        p["w_self"] = [glorot(gen, (d, d)) for _ in range(cfg.n_layers)]
    return _to_device(p, dev)


def params_from_jax(params_np: dict, device="cuda") -> dict:
    """Carry a JAX KG parameter pytree across, given as numpy arrays: a dict
    of arrays and lists of arrays (``entity``, ``relation`` and the
    model's own: KGAT ``att_basis``, ``att_coef``, ``w1``, ``w2``; KGCN
    ``w``, ``b``; KGIN ``intent``; R-GCN ``basis``, ``coef``, ``w_self``)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    p = {k: [t(w) for w in v] if isinstance(v, (list, tuple)) else t(v)
         for k, v in params_np.items()}
    return _to_device(p, resolve_device(device))


def _to_device(p: dict, dev: torch.device) -> dict:
    return {k: ([w.to(dev) for w in v] if isinstance(v, list) else v.to(dev))
            for k, v in p.items()}


def kgat_bi_interaction(p: dict, layer: int, e: torch.Tensor,
                        e_n: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(W1(e + eN)) + LeakyReLU(W2(e * eN)), four ACT sites
    resolved from the ambient context (``w1``, ``w2``, ``act1``, ``act2``)."""
    add = act_matmul(e + e_n, p["w1"][layer], scope="w1")
    mul = act_matmul(e * e_n, p["w2"][layer], scope="w2")
    add = act_nonlin(add, fn="leaky_relu", scope="act1")
    mul = act_nonlin(mul, fn="leaky_relu", scope="act2")
    return add + mul


def _self_rows(e: torch.Tensor, g) -> torch.Tensor:
    """The destination rows of a layer's input table (all of them on the
    full graph; the first ``n_dst`` on a block)."""
    return e if e.shape[0] == g.n_dst else e[:g.n_dst]


def _in_degree(g, dtype) -> torch.Tensor:
    """(n_dst, 1) in-degree, at least 1; on a block the mask summed by
    destination (every destination has ``fanout`` slots, masked ones
    included). No gradient flows into it."""
    if g.mask is None:
        deg = g.layout.in_degree().to(dtype)
    else:
        deg = ops.segment_sum(g.edge_ones(dtype), g.layout.runs())
    return torch.clamp_min(deg, 1.0)[:, None]


def _kgat_attention(p: dict, e: torch.Tensor, g) -> torch.Tensor:
    """pi(h,r,t) = (W_r e_t)ᵀ tanh(W_r e_h + e_r), softmaxed over dst.

    The basis projections ``(B, N, d)`` are computed once and mixed per
    edge. The JAX package gathers them as ``(B, E, d)`` tensors and contracts
    with one einsum; the port sums the ``B`` bases one ``(E, d)`` term at a
    time, which is the same function with a quarter of the peak memory.

    Every gather is ``gather_rows``: ``index_select`` forward, and backward
    a fixed-order segment sum over the edges of each table row (by source,
    destination or relation), the same bits every run. ``index_select``'s
    own backward, ``index_add_``, adds with atomics on the card (about 83,000
    edges into each row of the 80-row relation tables at full width); a
    ``tensor[idx]`` gather's, a sort-based ``index_put_``, walks each index's
    duplicates serially.

    On a block the projections cover the ``n_src`` rows of the layer-0
    table that the block reads (a prefix of it). On a shard they cover the
    shard's rows, and the source side reads them from every rank
    (``g.table`` along axis 1: one all-gather for the four bases).
    """
    src, dst, rel = g.src.long(), g.dst.long(), g.rel.long()
    by_src, by_dst = g.layout.runs(transpose=True), g.layout.runs()
    e = g.input_rows(e)
    proj = torch.stack([e @ p["att_basis"][b]
                        for b in range(p["att_basis"].shape[0])])
    proj_src = g.table(proj, axis=1)
    coef = gather_rows(p["att_coef"], rel, g.rel_runs)      # (E, B)
    eh = et = None
    for b in range(proj.shape[0]):
        c = coef[:, b:b + 1]
        th = c * gather_rows(proj_src[b], src, by_src)
        tt = c * gather_rows(proj[b], dst, by_dst)
        eh = th if eh is None else eh + th
        et = tt if et is None else et + tt
    logits = torch.sum(
        et * torch.tanh(eh + gather_rows(p["relation"], rel, g.rel_runs)),
        dim=-1)
    return segment_softmax(logits, g)


def _kgat_layer(p: dict, layer: int, e: torch.Tensor, g,
                att: torch.Tensor) -> torch.Tensor:
    e_n = act_spmm(g.table(e), att, g.layout, scope="spmm")
    return kgat_bi_interaction(p, layer, _self_rows(e, g), e_n)


def _kgcn_layer(p: dict, layer: int, e: torch.Tensor, g,
                ew: torch.Tensor) -> torch.Tensor:
    """KGNN-LS graph convolution: σ((Â E)Θ + b) with the relation-scored
    Â (``ew``); sigmoid, tanh on the last layer."""
    h = act_spmm(g.table(e), ew, g.layout, scope="spmm")
    j = act_matmul(h + _self_rows(e, g), p["w"][layer],
                   scope="dense") + p["b"][layer]
    return act_nonlin(j, scope="act",
                      fn="tanh" if layer == len(p["w"]) - 1 else "sigmoid")


def _kgin_layer(e: torch.Tensor, r_emb: torch.Tensor, g,
                deg: torch.Tensor) -> torch.Tensor:
    """Relational path aggregation (KGIN eq. 8): the mean over each
    destination's edges of ``e[src] * r_emb[rel]``, then LeakyReLU. The
    sum by destination is the fixed-order segment sum (``sum_rows``)."""
    msgs = g.mask_messages(
        gather_rows(g.table(e), g.src.long(), g.layout.runs(transpose=True))
        * gather_rows(r_emb, g.rel.long(), g.rel_runs))
    agg = sum_rows(msgs, g.dst.long(), g.layout.runs()) / deg
    return act_nonlin(agg, fn="leaky_relu", scope="act")


def _rgcn_layer(p: dict, layer: int, e: torch.Tensor, g,
                coef: list, deg: torch.Tensor) -> torch.Tensor:
    """Basis-decomposed R-GCN, ``W_r = Σ_b a_rb V_b``, basis-first.

    The reference builds the ``(E, B, d)`` messages and contracts them with
    one einsum; here ``Σ_e Σ_b coef[rel_e, b] proj_b[src_e]`` is ``Σ_b`` of
    one SPMM per basis with the edges' coefficients ``coef[b]`` (``(E,)``,
    from ``_edge_weights``) as edge weights: no ``(E, d)`` tensor, ∇proj by
    the transpose SPMM and ∇coef by the SDDMM. It sums in another order
    than the reference. On a shard the four projections come in through
    one ``g.tables`` call."""
    tabs = g.tables([act_matmul(e, p["basis"][b], scope=f"basis{b}")
                     for b in range(len(coef))])
    agg = None
    for pb, c in zip(tabs, coef):
        t = weighted_spmm(pb, c, g.layout)
        agg = t if agg is None else agg + t
    self_t = act_matmul(_self_rows(e, g), p["w_self"][layer], scope="self")
    return act_nonlin(agg / deg + self_t, fn="leaky_relu", scope="act")


def _edge_weights(p: dict, e0: torch.Tensor, g, cfg: KGNNConfig):
    """Per-edge weighting data of graph or block ``g``, computed from the
    layer-0 embeddings: kgat the attention probabilities (E,); kgcn the
    relation-scored adjacency (E,), a softmax over each destination of
    ``r · e0[src]``; kgin the intent-weighted relation table (R, d); rgcn
    the edges' basis coefficients ``coef[rel]`` (times the mask on a
    block), one (E,) column a basis (the reference gathers them in every
    layer; they are the same in each)."""
    if cfg.model == "kgat":
        return _kgat_attention(p, e0, g)
    if cfg.model == "kgcn":
        logits = torch.sum(
            gather_rows(p["relation"], g.rel.long(), g.rel_runs)
            * gather_rows(g.table(e0), g.src.long(),
                          g.layout.runs(transpose=True)),
            dim=-1)
        return segment_softmax(logits, g)
    if cfg.model == "kgin":
        alpha = torch.softmax(p["intent"], dim=-1)            # (P, R)
        return p["relation"] + torch.mean(alpha @ p["relation"], dim=0)
    coef = gather_rows(p["coef"], g.rel.long(), g.rel_runs)     # (E, B)
    return [g.mask_weights(c.contiguous()) for c in coef.unbind(1)]


def readout(outs: list, cfg: KGNNConfig) -> torch.Tensor:
    if cfg.readout == "concat":
        return torch.cat(outs, dim=-1)
    if cfg.readout == "sum":
        return sum(outs)
    return outs[-1]


def propagate_view(params: dict, view, cfg: KGNNConfig, ctx) -> list:
    """``cfg.n_layers`` layers of ``cfg.model`` over a view, under the
    entered ``ctx`` with ``layer<l>`` scopes; returns the per-layer outputs
    the readout keeps (``view.seed_rows``), layer 0 first. Layer ``l`` runs
    on ``view.layer_graph(l)``: the whole ``CKG``, block ``l`` of a
    ``SampledGraphView``, or the rank's ``ShardGraphView``. The edge
    weights and degrees are computed once per distinct layer graph, each
    from the layer-0 embeddings (KGIN's relation table once)."""
    view.check_depth(cfg.n_layers)
    graphs = [view.layer_graph(layer) for layer in range(cfg.n_layers)]
    e = view.local_rows(params["entity"])
    outs = [view.seed_rows(e)]
    weights, degs = {}, {}
    for g in graphs:
        if id(g) not in weights:
            weights[id(g)] = (next(iter(weights.values()))
                              if cfg.model == "kgin" and weights
                              else _edge_weights(params, e, g, cfg))
            degs[id(g)] = _in_degree(g, e.dtype)
    for layer, g in enumerate(graphs):
        w, deg = weights[id(g)], degs[id(g)]
        with ctx.scope(f"layer{layer}"):
            if cfg.model == "kgat":
                e = _kgat_layer(params, layer, e, g, w)
            elif cfg.model == "kgcn":
                e = _kgcn_layer(params, layer, e, g, w)
            elif cfg.model == "kgin":
                e = _kgin_layer(e, w, g, deg)
            else:
                e = _rgcn_layer(params, layer, e, g, w, deg)
        outs.append(view.seed_rows(e))
    return outs


def _reps(params: dict, view, cfg: KGNNConfig, who: str) -> torch.Tensor:
    model_sites(cfg)                                  # names the model
    ctx = model_context()
    ctx.check_key(who)
    with full_fp32(), ctx, ctx.scope(cfg.model):
        outs = propagate_view(params, view, cfg, ctx)
    return readout(outs, cfg)


def forward_reps(params: dict, g: CKG, cfg: KGNNConfig) -> torch.Tensor:
    """``cfg.n_layers`` layers of ``cfg.model`` message passing under the
    ambient ``ActContext`` (FP32 without one); the readout of every node.
    Under an active stochastic policy the context must carry a seed
    source: there is no silent constant seed (``ActContext.check_key``)."""
    return _reps(params, g, cfg, f"propagate({cfg.model})")


@torch.no_grad()
def propagate(params: dict, g: CKG, cfg: KGNNConfig) -> torch.Tensor:
    """The FP32 serving rollout: ``forward_reps`` with autograd off."""
    with act_context(FP32):
        return forward_reps(params, g, cfg)


def score_pairs(reps: torch.Tensor, users: torch.Tensor, items: torch.Tensor,
                n_users: int) -> torch.Tensor:
    """y_uv = e_uᵀ e_v; item node ids are offset by n_users in the CKG."""
    return torch.sum(reps[users.long()] * reps[items.long() + n_users], dim=-1)


def bpr_loss(params: dict, g: CKG, batch: dict,
             cfg: KGNNConfig) -> torch.Tensor:
    """BPR pairwise ranking loss + L2 over every parameter (the KGAT/KGIN
    objective); the sites resolve from the ambient context."""
    reps = forward_reps(params, g, cfg)
    pos = score_pairs(reps, batch["user"], batch["pos"], cfg.n_users)
    neg = score_pairs(reps, batch["user"], batch["neg"], cfg.n_users)
    loss = -torch.mean(torch.nn.functional.logsigmoid(pos - neg))
    return loss + cfg.l2 * g.param_l2(params)


def sampled_reps(params: dict, view: SampledGraphView,
                 cfg: KGNNConfig) -> torch.Tensor:
    """The readout of the seed rows of a sampled minibatch.
    ``params["entity"]`` is the gathered outermost frontier
    (``view.n_input_rows`` rows); the sites resolve under the same
    ``<model>/layer<l>/<site>`` scopes as ``forward_reps``."""
    return _reps(params, view, cfg, f"sampled_reps({cfg.model})")


def sampled_bpr_loss(params: dict, view: SampledGraphView,
                     cfg: KGNNConfig) -> torch.Tensor:
    """BPR over seeds packed ``[users | pos items | neg items]`` in thirds,
    scored by position; L2 over the parameters the step touches (the
    gathered entity rows and the dense parameters)."""
    reps = sampled_reps(params, view, cfg)
    b = view.n_seeds // 3
    pos = torch.sum(reps[:b] * reps[b:2 * b], dim=-1)
    neg = torch.sum(reps[:b] * reps[2 * b:3 * b], dim=-1)
    loss = -torch.mean(torch.nn.functional.logsigmoid(pos - neg))
    return loss + cfg.l2 * view.param_l2(params)


def kg_shard_reps(params: dict, view, cfg: KGNNConfig) -> torch.Tensor:
    """This shard's rows of the readout (port of
    ``repro/models/kgnn.py:kg_shard_reps``); the sites resolve from the
    ambient context under the same scopes as ``forward_reps``."""
    return _reps(params, view, cfg, f"kg_shard_reps({cfg.model})")


def kg_shard_loss(params: dict, view, batch: dict, cfg: KGNNConfig):
    """One shard's part of the global BPR objective plus the full L2 (port
    of ``repro/models/kgnn.py:kg_shard_loss``): ``(local batch BPR + l2 *
    reg, local batch BPR)``. With the batch split evenly over the ``data``
    ranks, the mean over them of the first is the global objective. The
    layers are ``propagate_view``'s, as on one device."""
    reps = view.unshard(kg_shard_reps(params, view, cfg))
    pos = score_pairs(reps, batch["user"], batch["pos"], cfg.n_users)
    neg = score_pairs(reps, batch["user"], batch["neg"], cfg.n_users)
    loss_loc = -torch.mean(torch.nn.functional.logsigmoid(pos - neg))
    return loss_loc + cfg.l2 * view.param_l2(params), loss_loc
