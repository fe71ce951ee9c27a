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

__all__ = ["KGNNConfig", "CKG", "BlockView", "SampledGraphView", "MODELS",
           "model_sites", "segment_softmax", "kgat_bi_interaction",
           "init_params", "params_from_jax", "propagate_view",
           "forward_reps", "propagate", "readout", "score_pairs", "bpr_loss",
           "sampled_reps", "sampled_bpr_loss"]

MODELS = ("kgat", "kgcn", "kgin", "rgcn")


@dataclasses.dataclass(frozen=True)
class CKG:
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
class BlockView:
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

    def to(self, device) -> "BlockView":
        return dataclasses.replace(
            self, layout=to_device(self.layout, device),
            rel_runs=to_device(self.rel_runs, device),
            **{k: getattr(self, k).to(device, non_blocking=True)
               for k in ("src", "dst", "rel", "mask")})


@dataclasses.dataclass(frozen=True)
class SampledGraphView:
    """A neighbour-sampled minibatch: one ``BlockView`` per layer,
    outermost hop first; the innermost hop's destinations are the
    ``n_seeds`` seeds. The entity table the model is given is the gathered
    outermost frontier (``n_input_rows`` rows; ``training.tiering``)."""

    blocks: tuple
    n_seeds: int

    @property
    def n_input_rows(self) -> int:
        return self.blocks[0].n_src

    def to(self, device) -> "SampledGraphView":
        return dataclasses.replace(
            self, blocks=tuple(b.to(device) for b in self.blocks))


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
    if g.mask is not None:
        logits = torch.where(g.mask > 0, logits, -1e30)
    mx = torch.full((g.n_dst,), float("-inf"), dtype=logits.dtype,
                    device=logits.device)
    mx = mx.scatter_reduce(0, seg, logits.detach(), reduce="amax",
                           include_self=True)
    ex = torch.exp(logits - mx.index_select(0, seg))
    ones = torch.ones((g.n_src, 1), dtype=ex.dtype, device=ex.device)
    den = weighted_spmm(ones, ex, g.layout)[:, 0]
    w = ex / (gather_rows(den, seg, g.layout.runs()) + 1e-16)
    return w if g.mask is None else w * g.mask


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
        deg = ops.segment_sum(g.mask.to(dtype), g.layout.runs())
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
    table that the block reads (a prefix of it).
    """
    src, dst, rel = g.src.long(), g.dst.long(), g.rel.long()
    by_src, by_dst = g.layout.runs(transpose=True), g.layout.runs()
    if e.shape[0] > g.n_src:
        e = e[:g.n_src]
    proj = torch.stack([e @ p["att_basis"][b]
                        for b in range(p["att_basis"].shape[0])])
    coef = gather_rows(p["att_coef"], rel, g.rel_runs)      # (E, B)
    eh = et = None
    for b in range(proj.shape[0]):
        c = coef[:, b:b + 1]
        th = c * gather_rows(proj[b], src, by_src)
        tt = c * gather_rows(proj[b], dst, by_dst)
        eh = th if eh is None else eh + th
        et = tt if et is None else et + tt
    logits = torch.sum(
        et * torch.tanh(eh + gather_rows(p["relation"], rel, g.rel_runs)),
        dim=-1)
    return segment_softmax(logits, g)


def _kgat_layer(p: dict, layer: int, e: torch.Tensor, g,
                att: torch.Tensor) -> torch.Tensor:
    e_n = act_spmm(e, att, g.layout, scope="spmm")
    return kgat_bi_interaction(p, layer, _self_rows(e, g), e_n)


def _kgcn_layer(p: dict, layer: int, e: torch.Tensor, g,
                ew: torch.Tensor) -> torch.Tensor:
    """KGNN-LS graph convolution: σ((Â E)Θ + b) with the relation-scored
    Â (``ew``); sigmoid, tanh on the last layer."""
    h = act_spmm(e, ew, g.layout, scope="spmm")
    j = act_matmul(h + _self_rows(e, g), p["w"][layer],
                   scope="dense") + p["b"][layer]
    return act_nonlin(j, scope="act",
                      fn="tanh" if layer == len(p["w"]) - 1 else "sigmoid")


def _kgin_layer(e: torch.Tensor, r_emb: torch.Tensor, g,
                deg: torch.Tensor) -> torch.Tensor:
    """Relational path aggregation (KGIN eq. 8): the mean over each
    destination's edges of ``e[src] * r_emb[rel]``, then LeakyReLU. The
    sum by destination is the fixed-order segment sum (``sum_rows``)."""
    msgs = (gather_rows(e, g.src.long(), g.layout.runs(transpose=True))
            * gather_rows(r_emb, g.rel.long(), g.rel_runs))
    if g.mask is not None:
        msgs = msgs * g.mask[:, None]
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
    than the reference."""
    agg = None
    for b, c in enumerate(coef):
        pb = act_matmul(e, p["basis"][b], scope=f"basis{b}")
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
            * gather_rows(e0, g.src.long(), g.layout.runs(transpose=True)),
            dim=-1)
        return segment_softmax(logits, g)
    if cfg.model == "kgin":
        alpha = torch.softmax(p["intent"], dim=-1)            # (P, R)
        return p["relation"] + torch.mean(alpha @ p["relation"], dim=0)
    coef = gather_rows(p["coef"], g.rel.long(), g.rel_runs)     # (E, B)
    if g.mask is not None:
        return [c * g.mask for c in coef.unbind(1)]
    return [c.contiguous() for c in coef.unbind(1)]


def readout(outs: list, cfg: KGNNConfig) -> torch.Tensor:
    if cfg.readout == "concat":
        return torch.cat(outs, dim=-1)
    if cfg.readout == "sum":
        return sum(outs)
    return outs[-1]


def propagate_view(params: dict, view, cfg: KGNNConfig, ctx) -> list:
    """``cfg.n_layers`` layers of ``cfg.model`` over a ``CKG`` (every layer
    on the whole graph) or a ``SampledGraphView`` (layer ``l`` on block
    ``l``, outputs cut to the seed rows), under the entered ``ctx`` with
    ``layer<l>`` scopes; returns the per-layer outputs, layer 0 first. On a
    sampled view the edge weights are computed per block, each from the
    layer-0 embeddings (KGIN's relation table once)."""
    sampled = isinstance(view, SampledGraphView)
    graphs = view.blocks if sampled else (view,) * cfg.n_layers
    if len(graphs) != cfg.n_layers:
        raise ValueError(f"{cfg.model} has {cfg.n_layers} layers, the "
                         f"view {len(graphs)} blocks")

    def keep(x):
        return x[:view.n_seeds] if sampled else x

    e = params["entity"]
    outs = [keep(e)]
    if sampled and cfg.model != "kgin":
        weights = [_edge_weights(params, e, g, cfg) for g in graphs]
    else:
        weights = [_edge_weights(params, e, graphs[0], cfg)] * cfg.n_layers
    degs = ([_in_degree(g, e.dtype) for g in graphs] if sampled
            else [_in_degree(view, e.dtype)] * cfg.n_layers)
    for layer, (g, w, deg) in enumerate(zip(graphs, weights, degs)):
        with ctx.scope(f"layer{layer}"):
            if cfg.model == "kgat":
                e = _kgat_layer(params, layer, e, g, w)
            elif cfg.model == "kgcn":
                e = _kgcn_layer(params, layer, e, g, w)
            elif cfg.model == "kgin":
                e = _kgin_layer(e, w, g, deg)
            else:
                e = _rgcn_layer(params, layer, e, g, w, deg)
        outs.append(keep(e))
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
    reg = sum(torch.sum(x ** 2) for x in param_leaves(params))
    return loss + cfg.l2 * reg


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
    reg = sum(torch.sum(x ** 2) for x in param_leaves(params))
    return loss + cfg.l2 * reg
