"""Model-step registry: ``--arch <id>`` -> one ``ModelStep`` (port of
``repro/models/registry.py``, KG family).

``build_step`` binds the KG layer functions (``models.kgnn``) to a dataset
and a config, with the reference's defaults: the small synthetic CKG, batch
512, data seed 2, lr 3e-3, dim 32, 3 layers, readout concat for kgat and
sum otherwise. A ``cfg`` may name another KG model than the arch's: R-GCN
has no arch id of its own, as in the reference, and trains as kgat's step
with its own config (``arch_of``, ``model_config``). The reference's other
archs raise ``NotImplementedError`` naming the slice of the port that
brings them (ROADMAP Queue 1).

KG steps carry a ``ShardSpec`` (``kg_dp_spec``: edges split by destination
over the ``data`` ranks, the entity table row-sharded over the ``model``
ranks of a 2D mesh), so every KG model trains on several ranks
(``training.data_parallel``).

``PATH_KERNELS`` lists the CUDA kernels a training step of each KG model
launches, for the checks that the path really went through them.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs import ARCHS, get
from repro_torch.kernels.backend import resolve_device
from repro_torch.training.step import ROW_SHARDED, ModelStep, ShardSpec, \
    enter_or_null, trainable

__all__ = ["build_step", "archs", "arch_of", "model_config", "path_kernels",
           "kg_dp_spec", "NOT_PORTED", "PATH_KERNELS"]

# the reference's archs that the port does not carry yet, and where they land
NOT_PORTED = {
    "gcn-cora": "slice 6 (the non-KG arch families)",
    **{a: "slice 6 (the non-KG arch families)" for a in (
        "mistral-large-123b", "codeqwen1.5-7b", "stablelm-12b",
        "moonshot-v1-16b-a3b", "grok-1-314b", "wide-deep", "dlrm-mlperf",
        "xdeepfm", "fm")},
}


# the kernels of a KG model's training step: (at FP32, added at INT-b)
PATH_KERNELS = {
    "kgat": (("spmm", "sddmm", "segment_sum"),
             ("quant_pack", "dequant_sddmm", "dequant_matmul")),
    "kgcn": (("spmm", "sddmm", "segment_sum"),
             ("quant_pack", "dequant_sddmm", "dequant_matmul")),
    "kgin": (("segment_sum",), ("quant_pack",)),
    "rgcn": (("spmm", "sddmm", "segment_sum"),
             ("quant_pack", "dequant_matmul")),
}

# the reference's defaults (repro/models/registry.py)
DATA_SEED = 2
LR = 3e-3
DIM = 32
N_LAYERS = 3


def kg_dp_spec(cfg, graph=None) -> ShardSpec:
    """The KG mesh contract (port of ``repro/models/registry.py:
    kg_dp_spec``): edges split by destination over ``data`` (``graph``: the
    host COO, a ``data.synthetic.KGDataset``), the batch split; the shard's
    objective is ``kgnn.kg_shard_loss`` over the same ``propagate_view``
    layers as one device; the entity table row-sharded over ``model`` (on
    a 1D ``data=N`` mesh the placement is inert)."""
    from repro_torch.models import kgnn

    return ShardSpec(
        graph=graph, scope=cfg.model, sites=kgnn.model_sites(cfg),
        n_layers=cfg.n_layers,
        shard_loss=functools.partial(kgnn.kg_shard_loss, cfg=cfg),
        shard_reps=functools.partial(kgnn.kg_shard_reps, cfg=cfg),
        placement=(("entity", ROW_SHARDED),))


def build_step(arch: str, *, ds=None, cfg=None, batch_size: int = 512,
               device="cuda", graph=None, n_layers: int = N_LAYERS,
               device_graph: bool = True) -> ModelStep:
    """The ``ModelStep`` of ``arch`` on ``device``. ``ds``/``cfg`` bring
    other sizes (``n_layers`` sizes the default config); ``graph``
    reuses a CKG already built on the device. With ``device_graph=False``
    no CKG or layout is built on the device (the sampled path,
    ``training.tiering``, builds per-batch blocks instead) and ``loss``
    raises."""
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
            n_layers=n_layers,
            readout="concat" if spec.model_cfg.model == "kgat" else "sum")
    g = graph if graph is not None or not device_graph else ds.graph(dev)

    def init(seed: int = 0):
        return trainable(kgnn.init_params(cfg, seed=seed, device=dev))

    def loss(params, batch, *, ctx=None):
        if g is None:
            raise ValueError("this step was built without the full graph "
                             "(device_graph=False): train it through "
                             "training.tiering.run_sampled_training")
        with enter_or_null(ctx):
            return kgnn.bpr_loss(params, g, batch, cfg)

    def batches():
        for b in bpr_batches(ds, batch_size, seed=DATA_SEED):
            yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    return ModelStep(arch=spec.name, family=spec.family, cfg=cfg, init=init,
                     loss=loss, batches=batches, lr=LR,
                     data={"graph": g, "dataset": ds, "device": dev},
                     dp_spec=kg_dp_spec(cfg, ds))


def arch_of(model: str) -> str:
    """The arch id whose step trains KG ``model``: R-GCN has none of its
    own and trains as kgat's step with its own config."""
    return "kgat" if model == "rgcn" else model


def model_config(model: str, spec=get):
    """The config of KG ``model`` from ``spec(arch)`` (an ``ArchSpec``:
    ``configs.get``, or a reduced one): the arch's own, and for R-GCN
    KGAT's with ``model="rgcn"`` and readout sum (4 bases, the config's
    default)."""
    cfg = spec(arch_of(model)).model_cfg
    if model == "rgcn":
        cfg = dataclasses.replace(cfg, model="rgcn", readout="sum")
    return cfg


def path_kernels(model: str, packed: bool) -> tuple[str, ...]:
    """The kernels a training step of KG ``model`` launches, with INT-b
    sites (``packed``) or at FP32."""
    fp32, more = PATH_KERNELS[model]
    return fp32 + (more if packed else ())


def archs() -> list[str]:
    """Every ``--arch`` the launcher accepts (ported or not)."""
    return sorted(set(ARCHS) | set(NOT_PORTED))
