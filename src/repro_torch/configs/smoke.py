"""Reduced configs for CPU runs (port of the gnn, recsys and kgnn branches
of ``repro/configs/smoke.py``): same topology, tiny widths."""

from __future__ import annotations

import dataclasses

from .base import ArchSpec

__all__ = ["reduced"]


def reduced(arch: ArchSpec) -> ArchSpec:
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
