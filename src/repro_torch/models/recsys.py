"""RecSys architectures: FM, Wide&Deep, DLRM, xDeepFM (port of
``repro/models/recsys.py``).

Embedding storage is ONE fused table ``(Σ vocab_f, dim)`` with static
per-field offsets, and a ``(Σ vocab_f, 1)`` linear table beside it. The
interaction ops and MLPs run through the ACT layer (``act_matmul``,
``act_dense``, ``act_relu``), compressing the activations that dominate
training memory at CTR batch sizes: xDeepFM's CIN input is ``(B, k,
H·F)``. The lookups keep index residuals only.

The lookups' backward is deterministic: a batch's flat ids are grouped by
distinct id on the host (``lookup_plan``: ``data.csr.lookup_plan``, one
``SegmentRuns`` level over the batch's positions, never over the whole
table), each distinct row's gradient is the fixed-order segment sum of its
positions (``core.act.lookup_rows``; the ``segment_sum`` kernel on the
card), and the sums are copied into the dense table gradient at their
distinct rows: no atomics. The optimizer stays the reference's dense Adam
over the whole table. A batch that trains the tables carries its plan
(``batch["lookup"]``; the registry's step builds it beside each batch);
one without a plan gathers with ``index_select`` and may not train the
tables.

Parameters come from a seeded ``torch.Generator`` on the device
(``init_params``) or the reference's, carried across (``params_from_jax``).
An MLP's layers are two lists, ``<name>_w`` and ``<name>_b``
(``models.layers``). DLRM's logit reads neither ``linear`` nor ``bias``:
its registry step lists them as ``unread`` and they get zero gradient, as
the reference's (``retrieval_towers`` reads ``linear``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.act import act_matmul, lookup_rows
from repro_torch.core.context import model_context
from repro_torch.data.csr import LookupPlan
from repro_torch.data.csr import lookup_plan as csr_lookup_plan
from repro_torch.kernels.backend import full_fp32, resolve_device

from .layers import mlp_apply, mlp_params, normal_init

__all__ = ["RecsysConfig", "LookupPlan", "init_params", "params_from_jax",
           "lookup_plan", "forward", "retrieval_scores", "retrieval_towers",
           "MLPS"]

# the MLPs a model may have, each stored as <name>_w / <name>_b lists
MLPS = ("bot", "top", "deep")


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    model: str                      # fm | wide_deep | dlrm | xdeepfm
    n_sparse: int
    vocab_sizes: tuple              # per-field vocab sizes
    embed_dim: int
    n_dense: int = 0
    bot_mlp: tuple = ()             # dlrm bottom MLP dims (excl. input)
    top_mlp: tuple = ()             # dlrm top MLP dims (incl. final 1)
    mlp: tuple = ()                 # deep branch dims (wide_deep/xdeepfm)
    cin_layers: tuple = ()          # xdeepfm CIN layer widths
    interaction: str = "dot"
    vocab_pad: int = 512            # fused table rows round up to this

    @property
    def total_vocab(self) -> int:
        n = int(sum(self.vocab_sizes))
        return -(-n // self.vocab_pad) * self.vocab_pad

    @property
    def field_offsets(self) -> tuple:
        off, acc = [], 0
        for v in self.vocab_sizes:
            off.append(acc)
            acc += v
        return tuple(off)


def _put_mlp(p: dict, name: str, mlp: dict) -> None:
    p[f"{name}_w"], p[f"{name}_b"] = mlp["w"], mlp["b"]


def init_params(cfg: RecsysConfig, *, seed: int = 0, device="cuda") -> dict:
    """The reference's parameters and initializers (table N(0, 1/k), linear
    N(0, 0.01²), bias 0, MLPs Glorot-uniform with zero biases, CIN and
    ``cin_out`` N(0, 0.1²)), drawn on ``device`` from a generator seeded
    with ``seed`` (a full-size table is too large to draw on the host)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    F, k = cfg.n_sparse, cfg.embed_dim
    p = {
        "table": normal_init(gen, (cfg.total_vocab, k), 1.0 / k**0.5),
        "linear": normal_init(gen, (cfg.total_vocab, 1), 0.01),
        "bias": torch.zeros((), device=dev),
    }
    if cfg.model == "wide_deep":
        _put_mlp(p, "deep", mlp_params(
            gen, (F * k + cfg.n_dense,) + cfg.mlp + (1,)))
    elif cfg.model == "dlrm":
        _put_mlp(p, "bot", mlp_params(gen, (cfg.n_dense,) + cfg.bot_mlp))
        n_vec = F + 1  # embeddings + bottom-MLP output
        d_int = n_vec * (n_vec - 1) // 2 + cfg.bot_mlp[-1]
        _put_mlp(p, "top", mlp_params(gen, (d_int,) + cfg.top_mlp))
    elif cfg.model == "xdeepfm":
        h_prev, p["cin"] = F, []
        for h in cfg.cin_layers:
            p["cin"].append(normal_init(gen, (h_prev * F, h), 0.1))
            h_prev = h
        p["cin_out"] = normal_init(gen, (int(sum(cfg.cin_layers)), 1), 0.1)
        _put_mlp(p, "deep", mlp_params(gen, (F * k,) + cfg.mlp + (1,)))
    elif cfg.model != "fm":
        raise ValueError(cfg.model)
    return p


def params_from_jax(params_np: dict, device="cuda") -> dict:
    """Carry the reference's parameter tree, given as numpy arrays, across:
    ``table``, ``linear``, ``bias``, the ``cin`` list and ``cin_out`` as
    they are, each ``deep``/``bot``/``top`` list of ``{w, b}`` as its
    ``<name>_w`` and ``<name>_b`` lists."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    p = {}
    for k, v in params_np.items():
        if k in MLPS:
            p[f"{k}_w"] = [t(layer["w"]) for layer in v]
            p[f"{k}_b"] = [t(layer["b"]) for layer in v]
        elif isinstance(v, (list, tuple)):
            p[k] = [t(w) for w in v]
        else:
            p[k] = t(v)
    return p


def lookup_plan(sparse, cfg: RecsysConfig, device="cuda") -> LookupPlan:
    """The ``LookupPlan`` of a ``(B, F)`` batch of field-local ids (numpy):
    ``data.csr.lookup_plan`` of the fused table's rows."""
    flat = (np.asarray(sparse, np.int64)
            + np.asarray(cfg.field_offsets, np.int64)[None, :])
    return csr_lookup_plan(flat, cfg.total_vocab, resolve_device(device))


def _lookup(params, sparse_ids: torch.Tensor, cfg: RecsysConfig,
            plan: LookupPlan | None = None, *, linear: bool = True):
    """(B, F) field-local ids -> (B, F, k) embeddings and the (B,) linear
    term (None without ``linear``), through ``lookup_rows``: training the
    tables needs ``plan``."""
    B, F = sparse_ids.shape
    tables = [params["table"]] + ([params["linear"]] if linear else [])
    ids = None
    if plan is None:
        offs = torch.tensor(cfg.field_offsets, dtype=torch.int64,
                            device=sparse_ids.device)
        ids = (sparse_ids.long() + offs[None, :]).reshape(-1)
    got = [lookup_rows(t, plan, ids) for t in tables]
    emb = got[0].reshape(B, F, cfg.embed_dim)
    return emb, (torch.sum(got[1].reshape(B, F), dim=-1) if linear
                 else None)


def _fm_pairwise(emb: torch.Tensor) -> torch.Tensor:
    """Σ_{i<j} <v_i, v_j> via the O(Fk) sum-square trick (Rendle '10)."""
    s = torch.sum(emb, dim=1)            # (B, k)
    sq = torch.sum(emb * emb, dim=1)     # (B, k)
    return 0.5 * torch.sum(s * s - sq, dim=-1)


class _TakeCols(torch.autograd.Function):
    """``x[:, idx]`` for distinct ``idx``: the backward copies the gradient
    back to its columns (no accumulation, so no atomics)."""

    @staticmethod
    def forward(fctx, x, idx):
        fctx.save_for_backward(idx)
        fctx.shape = x.shape
        return x.index_select(1, idx)

    @staticmethod
    def backward(fctx, g):
        (idx,) = fctx.saved_tensors
        return g.new_zeros(fctx.shape).index_copy_(1, idx, g), None


def _dot_interaction(vectors: torch.Tensor) -> torch.Tensor:
    """DLRM: upper-triangle pairwise dots of (B, n, k) -> (B, n(n-1)/2), in
    ``triu_indices`` order."""
    B, n, _ = vectors.shape
    gram = torch.bmm(vectors, vectors.transpose(1, 2))
    iu, ju = torch.triu_indices(n, n, 1, device=vectors.device)
    return _TakeCols.apply(gram.reshape(B, n * n), iu * n + ju)


def _cin(params, x0: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """Compressed Interaction Network: x^l_h = Σ_{ij} W^l_{h,ij}(x^{l-1}_i ⊙
    x^0_j). The outer product along fields is formed directly as the
    reference's ``zt`` (B, k, H_prev·F), column ``h·F + f``, and contracted
    against W by one ``act_matmul`` at ``cin<i>``."""
    B, F, k = x0.shape
    x0t = x0.transpose(1, 2)                             # (B, k, F)
    xst, pooled = x0t, []
    for i, w in enumerate(params["cin"]):
        zt = (xst[:, :, :, None] * x0t[:, :, None, :]).reshape(B, k, -1)
        xst = act_matmul(zt, w, scope=f"cin{i}")         # (B, k, H)
        pooled.append(torch.sum(xst, dim=1))             # (B, H)
    return torch.cat(pooled, dim=-1)


def _mlp(params, name: str, x, **kw):
    return mlp_apply(params[f"{name}_w"], params[f"{name}_b"], x, scope=name,
                     **kw)


def forward(params: dict, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """Logits (B,). ``batch``: ``sparse`` (B, F) int field-local ids
    [+ ``dense`` (B, n_dense)] [+ ``lookup``, its ``LookupPlan``]. The ACT
    sites resolve from the ambient ``ActContext`` (FP32 without one) at
    ``<model>/...``; the forward and backward run in full fp32."""
    ctx = model_context()
    ctx.check_key(f"recsys.forward({cfg.model})")
    with full_fp32(), ctx, ctx.scope(cfg.model):
        emb, lin = _lookup(params, batch["sparse"], cfg, batch.get("lookup"),
                           linear=cfg.model != "dlrm")
        B = emb.shape[0]

        if cfg.model == "fm":
            return params["bias"] + lin + _fm_pairwise(emb)

        if cfg.model == "wide_deep":
            x = emb.reshape(B, -1)
            if cfg.n_dense:
                x = torch.cat([x, batch["dense"]], dim=-1)
            deep = _mlp(params, "deep", x)[:, 0]
            return params["bias"] + lin + deep

        if cfg.model == "dlrm":
            bot = _mlp(params, "bot", batch["dense"], final_act=True)
            vecs = torch.cat([bot[:, None, :], emb], dim=1)
            inter = _dot_interaction(vecs)               # (B, n(n-1)/2)
            top_in = torch.cat([bot, inter], dim=-1)
            return _mlp(params, "top", top_in)[:, 0]

        if cfg.model == "xdeepfm":
            cin_feats = _cin(params, emb, cfg)
            cin_logit = act_matmul(cin_feats, params["cin_out"],
                                   scope="cin_out")[:, 0]
            deep = _mlp(params, "deep", emb.reshape(B, -1))[:, 0]
            return params["bias"] + lin + cin_logit + deep

    raise ValueError(cfg.model)


def retrieval_scores(params: dict, query: dict, cand_ids: torch.Tensor,
                     cfg: RecsysConfig, *, item_field: int = 0):
    """Score ONE query against N candidates as a single batched dot: the
    user vector is the sum of the query's field embeddings (the candidate
    field left out), the candidate vector its embedding row, plus its
    linear term (the two-tower retrieval head; a full model re-ranks the
    top-K)."""
    with full_fp32():
        emb, _ = _lookup(params, query["sparse"][None, :], cfg,
                         linear=False)                         # (1, F, k)
        mask = (torch.arange(cfg.n_sparse, device=emb.device)
                != item_field).to(emb.dtype)
        user_vec = torch.sum(emb[0] * mask[:, None], dim=0)    # (k,)
        ids = cand_ids.long() + cfg.field_offsets[item_field]
        cand = params["table"].index_select(0, ids)            # (N, k)
        cand_lin = params["linear"].index_select(0, ids)[:, 0]
        return cand @ user_vec + cand_lin


def retrieval_towers(params: dict, query_sparse: torch.Tensor,
                     cand_ids: torch.Tensor, cfg: RecsysConfig, *,
                     item_field: int = 0):
    """The two towers behind :func:`retrieval_scores`, as row tables:
    ``score(u, v) = cand_emb_v · user_vec_u + cand_lin_v`` as one dot
    product, the user side augmented by a constant 1 and the item side by
    its linear term (the layout of the packed serving store: the item
    tower packed once, the user tower the per-request query).

    query_sparse : (B, F) field-local ids
    returns (user_aug (B, k+1) fp32, cand_aug (N, k+1) fp32) with
    ``cand_aug @ user_aug[i]`` == ``retrieval_scores`` for query i.
    """
    with full_fp32():
        emb, _ = _lookup(params, query_sparse, cfg, linear=False)
        mask = (torch.arange(cfg.n_sparse, device=emb.device)
                != item_field).to(emb.dtype)
        user_vec = torch.sum(emb * mask[None, :, None], dim=1)  # (B, k)
        user_aug = torch.cat([user_vec, torch.ones_like(user_vec[:, :1])],
                             dim=-1)
        ids = cand_ids.long() + cfg.field_offsets[item_field]
        cand = params["table"].index_select(0, ids)             # (N, k)
        cand_lin = params["linear"].index_select(0, ids)        # (N, 1)
        cand_aug = torch.cat([cand, cand_lin], dim=-1)
        return user_aug.to(torch.float32), cand_aug.to(torch.float32)
