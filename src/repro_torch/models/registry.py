"""Model-step registry: ``--arch <id>`` -> one ``ModelStep`` (port of
``repro/models/registry.py``, KG family, KGAT only).

``build_step`` binds the KGAT layer functions (``models.kgnn``) to a
dataset and a config, with the reference's defaults: the small synthetic
CKG, batch 512, data seed 2, lr 3e-3, dim 32, 3 layers, concat readout.
The reference's other archs raise ``NotImplementedError`` naming the slice
of the port that brings them (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

from repro_torch.configs import ARCHS, get
from repro_torch.kernels.backend import resolve_device
from repro_torch.training.step import ModelStep, enter_or_null, trainable

__all__ = ["build_step", "archs", "NOT_PORTED"]

# the reference's archs that the port does not carry yet, and where they land
NOT_PORTED = {
    **{a: "the KG layers deferred from slice 2" for a in ("kgcn", "kgin")},
    "gcn-cora": "slice 6 (the non-KG arch families)",
    **{a: "slice 6 (the non-KG arch families)" for a in (
        "mistral-large-123b", "codeqwen1.5-7b", "stablelm-12b",
        "moonshot-v1-16b-a3b", "grok-1-314b", "wide-deep", "dlrm-mlperf",
        "xdeepfm", "fm")},
}


# the reference's defaults (repro/models/registry.py)
DATA_SEED = 2
LR = 3e-3
DIM = 32
N_LAYERS = 3


def build_step(arch: str, *, ds=None, cfg=None, batch_size: int = 512,
               device="cuda", graph=None) -> ModelStep:
    """The ``ModelStep`` of ``arch`` on ``device``. ``ds``/``cfg`` bring
    other sizes; ``graph`` reuses a CKG already built on the device."""
    from repro_torch.data.synthetic import bpr_batches, gen_kg_dataset
    from repro_torch.models import kgnn

    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"--arch {arch} is not ported yet; it comes with "
            f"{NOT_PORTED[arch]} (ROADMAP Queue 1)")
    spec = get(arch)
    dev = resolve_device(device)
    if ds is None:
        ds = gen_kg_dataset(n_users=120, n_items=200, n_attrs=80, seed=0)
    if cfg is None:
        cfg = kgnn.KGNNConfig(
            model=spec.model_cfg.model, n_users=ds.n_users,
            n_entities=ds.n_entities, n_relations=ds.n_relations, dim=DIM,
            n_layers=N_LAYERS, readout="concat")
    g = graph if graph is not None else ds.graph(dev)

    def init(seed: int = 0):
        return trainable(kgnn.init_params(cfg, seed=seed, device=dev))

    def loss(params, batch, *, ctx=None):
        with enter_or_null(ctx):
            return kgnn.bpr_loss(params, g, batch, cfg)

    def batches():
        for b in bpr_batches(ds, batch_size, seed=DATA_SEED):
            yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    return ModelStep(arch=spec.name, family=spec.family, cfg=cfg, init=init,
                     loss=loss, batches=batches, lr=LR,
                     data={"graph": g, "dataset": ds})


def archs() -> list[str]:
    """Every ``--arch`` the launcher accepts (ported or not)."""
    return sorted(set(ARCHS) | set(NOT_PORTED))
