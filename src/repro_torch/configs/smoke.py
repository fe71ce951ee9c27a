"""Reduced configs for CPU runs (port of ``repro/configs/smoke.py``): same
topology (GQA ratio, MoE routing, CIN stack, field count), tiny widths."""

from __future__ import annotations

import dataclasses

from .base import ArchSpec

__all__ = ["reduced"]


def reduced(arch: ArchSpec) -> ArchSpec:
    if arch.family in ("lm", "moe_lm"):
        from repro_torch.models.moe import MoEConfig

        cfg = arch.model_cfg
        kv_ratio = max(cfg.n_heads // cfg.n_kv_heads, 1)
        moe = None
        d_ff = 128
        if cfg.moe is not None:
            moe = MoEConfig(n_experts=min(cfg.moe.n_experts, 8),
                            top_k=min(cfg.moe.top_k, 2), d_ff=64)
            d_ff = 0
        small = dataclasses.replace(
            cfg, n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=max(4 // kv_ratio, 1), d_head=16, d_ff=d_ff,
            vocab=512, moe=moe, dtype="float32", q_chunk=16, kv_chunk=16)
        return dataclasses.replace(arch, model_cfg=small)
    if arch.family == "gnn":
        small = dataclasses.replace(arch.model_cfg, d_in=32, d_hidden=16,
                                    n_classes=7)
        return dataclasses.replace(arch, model_cfg=small)
    if arch.family == "recsys":
        from repro_torch.models.recsys import RecsysConfig

        cfg = arch.model_cfg
        embed_dim = min(cfg.embed_dim, 16)
        bot = tuple(min(d, 32) for d in cfg.bot_mlp)
        if bot:
            bot = bot[:-1] + (embed_dim,)  # DLRM: bot output == embed dim
        small = RecsysConfig(
            model=cfg.model,
            n_sparse=cfg.n_sparse,
            vocab_sizes=tuple(min(v, 1000) for v in cfg.vocab_sizes),
            embed_dim=embed_dim,
            n_dense=cfg.n_dense,
            bot_mlp=bot,
            top_mlp=tuple(min(d, 32) for d in cfg.top_mlp),
            mlp=tuple(min(d, 32) for d in cfg.mlp),
            cin_layers=tuple(min(d, 16) for d in cfg.cin_layers),
            interaction=cfg.interaction,
        )
        return dataclasses.replace(arch, model_cfg=small)
    if arch.family != "kgnn":
        raise ValueError(f"the port has no reduced config for {arch.family}")
    small = dataclasses.replace(arch.model_cfg, n_users=40, n_entities=80,
                                n_relations=10, dim=16, n_layers=2)
    return dataclasses.replace(arch, model_cfg=small)
