"""KGAT over a collaborative knowledge graph (port of ``repro/models/kgnn.py``,
KGAT only): the FP32 serving rollout and activation-compressed training.

Users, items and attribute entities share one node space; user-item
interactions are the ``interact`` relation, merged with the item KG. KGAT's
attention is computed once from the layer-0 embeddings with the
basis-decomposed relation projection ``W_r = sum_b a_rb V_b`` (DESIGN.md
section 3), softmaxed over each destination's edges; each layer aggregates
with the SPMM kernel over the graph's blocked-CSR layout and applies the
bi-interaction aggregator; the readout concatenates every layer.

One layer function serves both paths. Its five sites (``spmm``, ``w1``,
``w2``, ``act1``, ``act2`` under ``kgat/layer<l>/``) are ACT ops
(``repro_torch.core.act``) that resolve their policy and seed from the
ambient ``ActContext``: ``bpr_loss`` runs them under the training schedule,
``propagate`` under FP32 with autograd off. The attention is not an ACT
site, as in the reference: autograd keeps its (E, d) tensors uncompressed.

Aggregation sums are deterministic on the card: the SPMM kernel sums each
destination in slot order without atomics, and the edge-softmax
denominators are that same kernel run over a ones column (their ∇ew the
SDDMM kernel on the same column). The attention's own gathers
backpropagate through ``index_add``, which uses atomics on CUDA, so two
training steps on the card may differ in the last bits. Every matmul runs in
full fp32: ``forward_reps`` and the training step switch TF32 off for their
own span (``kernels.backend.full_fp32``) and restore the caller's setting.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.act import act_matmul, act_nonlin, act_spmm, \
    weighted_spmm
from repro_torch.core.context import act_context, model_context
from repro_torch.core.policy import FP32
from repro_torch.data.csr import attach_layout
from repro_torch.kernels.backend import full_fp32, resolve_device

from .layers import glorot, normal_init, param_leaves

__all__ = ["KGNNConfig", "CKG", "segment_softmax", "kgat_bi_interaction",
           "init_params", "params_from_jax", "forward_reps", "propagate",
           "readout", "score_pairs", "bpr_loss"]


@dataclasses.dataclass(frozen=True)
class CKG:
    """Collaborative knowledge graph in COO form (inverse edges included),
    always with its blocked-CSR ``layout`` on the same device."""

    src: torch.Tensor  # (E,) int32 node ids
    dst: torch.Tensor  # (E,) int32 node ids
    rel: torch.Tensor  # (E,) int32 relation ids
    n_nodes: int
    n_relations: int
    layout: object = None

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
class KGNNConfig:
    model: str = "kgat"          # the port carries kgat only
    n_users: int = 0
    n_entities: int = 0          # items + attribute entities
    n_relations: int = 0         # incl. `interact`, both directions
    dim: int = 64                # embedding size (paper fixes 64)
    n_layers: int = 3            # paper fixes 3
    layer_dims: tuple = ()       # per-layer out dims; default = dim each
    n_bases: int = 4             # relation-projection bases
    l2: float = 1e-5             # L2 weight of bpr_loss
    readout: str = "concat"      # concat (KGAT) | sum | last

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_entities

    @property
    def dims(self) -> tuple:
        return self.layer_dims or (self.dim,) * self.n_layers


def _check_kgat(cfg: KGNNConfig) -> None:
    if cfg.model != "kgat":
        raise NotImplementedError(
            f"the port carries KGAT only; {cfg.model!r} is not ported yet")


def segment_softmax(logits: torch.Tensor, g: CKG) -> torch.Tensor:
    """Numerically stable softmax of per-edge logits over each destination.

    The max is ``scatter_reduce(amax)`` (order-free) and carries no
    gradient: the softmax does not depend on the shift, so its derivative
    through the max is zero. The denominators are the SPMM of a ones column
    with the exponentials as edge weights, summed in the layout's dst-sorted
    slot order, deterministically; their ∇ew (``g_den[dst_e]``) is the SDDMM
    of the same column. That SPMM is no ACT site and records nothing.
    """
    seg = g.dst.long()
    mx = torch.full((g.n_nodes,), float("-inf"), dtype=logits.dtype,
                    device=logits.device)
    mx = mx.scatter_reduce(0, seg, logits.detach(), reduce="amax",
                           include_self=True)
    ex = torch.exp(logits - mx.index_select(0, seg))
    ones = torch.ones((g.n_nodes, 1), dtype=ex.dtype, device=ex.device)
    den = weighted_spmm(ones, ex, g.layout)[:, 0]
    return ex / (den.index_select(0, seg) + 1e-16)


def init_params(cfg: KGNNConfig, *, seed: int = 0, device="cuda") -> dict:
    """KGAT parameters from a seeded CPU ``torch.Generator``, moved to
    ``device`` (the same seed gives the same values on every device)."""
    _check_kgat(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d = cfg.dim
    dims = (d,) + cfg.dims
    p = {
        "entity": normal_init(gen, (cfg.n_nodes, d), 0.1),
        "relation": normal_init(gen, (cfg.n_relations, d), 0.1),
        "att_basis": normal_init(gen, (cfg.n_bases, d, d), 0.1),
        "att_coef": normal_init(gen, (cfg.n_relations, cfg.n_bases), 0.1),
        "w1": [glorot(gen, (a, b)) for a, b in zip(dims[:-1], dims[1:])],
        "w2": [glorot(gen, (a, b)) for a, b in zip(dims[:-1], dims[1:])],
    }
    return _to_device(p, dev)


def params_from_jax(params_np: dict, device="cuda") -> dict:
    """Carry the JAX KGAT parameter pytree across, given as numpy arrays:
    ``entity``, ``relation``, ``att_basis``, ``att_coef`` and the lists
    ``w1`` and ``w2``."""
    dev = resolve_device(device)
    p = {k: torch.from_numpy(np.array(params_np[k], np.float32))
         for k in ("entity", "relation", "att_basis", "att_coef")}
    for k in ("w1", "w2"):
        p[k] = [torch.from_numpy(np.array(w, np.float32))
                for w in params_np[k]]
    return _to_device(p, dev)


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


def _kgat_attention(p: dict, e: torch.Tensor, g: CKG) -> torch.Tensor:
    """pi(h,r,t) = (W_r e_t)ᵀ tanh(W_r e_h + e_r), softmaxed over dst.

    The basis projections ``(B, N, d)`` are computed once and mixed per
    edge. The JAX package gathers them as ``(B, E, d)`` tensors and contracts
    with one einsum; the port sums the ``B`` bases one ``(E, d)`` term at a
    time, which is the same function with a quarter of the peak memory.

    Every gather is ``index_select``, whose backward is ``index_add_``. A
    ``tensor[idx]`` gather backpropagates through a sort-based
    ``index_put_`` instead, which on the card walks each index's
    duplicates serially: the relation tables (80 rows) take about 83,000
    edges a row at full width.
    """
    src, dst, rel = g.src.long(), g.dst.long(), g.rel.long()
    proj = torch.stack([e @ p["att_basis"][b]
                        for b in range(p["att_basis"].shape[0])])
    coef = p["att_coef"].index_select(0, rel)               # (E, B)
    eh = et = None
    for b in range(proj.shape[0]):
        c = coef[:, b:b + 1]
        th = c * proj[b].index_select(0, src)
        tt = c * proj[b].index_select(0, dst)
        eh = th if eh is None else eh + th
        et = tt if et is None else et + tt
    logits = torch.sum(
        et * torch.tanh(eh + p["relation"].index_select(0, rel)), dim=-1)
    return segment_softmax(logits, g)


def _kgat_layer(p: dict, layer: int, e: torch.Tensor, g: CKG,
                att: torch.Tensor) -> torch.Tensor:
    e_n = act_spmm(e, att, g.layout, scope="spmm")
    return kgat_bi_interaction(p, layer, e, e_n)


def readout(outs: list, cfg: KGNNConfig) -> torch.Tensor:
    if cfg.readout == "concat":
        return torch.cat(outs, dim=-1)
    if cfg.readout == "sum":
        return sum(outs)
    return outs[-1]


def forward_reps(params: dict, g: CKG, cfg: KGNNConfig) -> torch.Tensor:
    """L layers of KGAT message passing under the ambient ``ActContext``
    (FP32 without one); the readout of every node. Under an active
    stochastic policy the context must carry a seed source: there is no
    silent constant seed (``ActContext.check_key``)."""
    _check_kgat(cfg)
    ctx = model_context()
    ctx.check_key(f"propagate({cfg.model})")
    with full_fp32(), ctx, ctx.scope(cfg.model):
        e = params["entity"]
        outs = [e]
        att = _kgat_attention(params, e, g)
        for layer in range(cfg.n_layers):
            with ctx.scope(f"layer{layer}"):
                e = _kgat_layer(params, layer, e, g, att)
            outs.append(e)
    return readout(outs, cfg)


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
    """BPR pairwise ranking loss + L2 over every parameter (the KGAT
    objective); the sites resolve from the ambient context."""
    reps = forward_reps(params, g, cfg)
    pos = score_pairs(reps, batch["user"], batch["pos"], cfg.n_users)
    neg = score_pairs(reps, batch["user"], batch["neg"], cfg.n_users)
    loss = -torch.mean(torch.nn.functional.logsigmoid(pos - neg))
    reg = sum(torch.sum(x ** 2) for x in param_leaves(params))
    return loss + cfg.l2 * reg
