"""Model-step registry: ``--arch <id>`` -> one ``ModelStep`` (port of
``repro/models/registry.py``, the KG, GNN and recsys families).

``build_step`` binds the layer functions (``models.kgnn``, ``models.gnn``)
to a dataset and a config. KG steps take the reference's defaults: the
small synthetic CKG, batch 512, data seed 2, lr 3e-3, dim 32, 3 layers,
readout concat for kgat and sum otherwise. A ``cfg`` may name another KG
model than the arch's: R-GCN has no arch id of its own, as in the
reference, and trains as kgat's step with its own config (``arch_of``,
``model_config``). ``gcn-cora`` trains node classification under the
reference's full-graph mean cross-entropy at lr 1e-2: on the CPU the
reduced config on ``cora_like(n_nodes=300)``, as the reference's step; on
the card the full config on the ``full_graph_sm`` shape, or any of
``GNN_SHAPES`` (``gnn_config``, ``gnn_data``). The recsys archs (fm, wide-deep,
dlrm-mlperf, xdeepfm) train CTR under the reference's mean logistic loss
at lr 1e-3 on ``criteo_batches(seed=3)``: on the CPU the reduced config at
batch 256, as the reference's step; on the card the full config at batch
4,096 (xDeepFM's published batch), each table capped at ``row_cap`` rows
where asked (``recsys_config``); a config whose training state does not
fit the card is refused before anything is allocated (``check_fits``).
The LM archs (``lm`` and ``moe_lm``) train next-token cross entropy on
``lm_batches(seed=0)`` with Adam at 1e-3, each batch with its embedding's
``data.csr.lookup_plan``: on the CPU the reduced config at batch 8, seq 64,
as the reference's step; on the card the arch's published widths in
bfloat16 at ``LM_CARD_LAYERS`` layers, batch ``LM_CARD_BATCH`` at seq
4,096 (``train_4k``'s sequence; ``lm_config``).

KG steps carry a ``ShardSpec`` (``kg_dp_spec``: edges split by destination
over the ``data`` ranks, the entity table row-sharded over the ``model``
ranks of a 2D mesh), so every KG model trains on several ranks
(``training.data_parallel``); the GCN and recsys steps carry the
reference's ``dp_unsupported`` reasons instead.

``PATH_KERNELS`` lists the CUDA kernels a training step of each model
launches, for the checks that the path really went through them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs import ARCHS, get
from repro_torch.kernels.backend import resolve_device
from repro_torch.training.step import ROW_SHARDED, ModelStep, ShardSpec, \
    enter_or_null, trainable

__all__ = ["build_step", "family_of", "archs", "arch_of", "model_config",
           "path_kernels", "kg_dp_spec", "gnn_config", "gnn_data",
           "recsys_config", "check_fits", "lm_config", "NOT_PORTED",
           "PATH_KERNELS", "GNN_DP_UNSUPPORTED", "RECSYS_DP_UNSUPPORTED",
           "LM_DP_UNSUPPORTED"]

# the reference's archs that the port does not carry yet, and where they land
NOT_PORTED: dict[str, str] = {}


# the kernels of a model's training step: (at FP32, added at INT-b)
PATH_KERNELS = {
    "kgat": (("spmm", "sddmm", "segment_sum"),
             ("quant_pack", "dequant_sddmm", "dequant_matmul")),
    "kgcn": (("spmm", "sddmm", "segment_sum"),
             ("quant_pack", "dequant_sddmm", "dequant_matmul")),
    "kgin": (("segment_sum",), ("quant_pack",)),
    "rgcn": (("spmm", "sddmm", "segment_sum"),
             ("quant_pack", "dequant_matmul")),
    "gcn": (("spmm",), ("quant_pack", "dequant_matmul")),
    # the recsys models: the table gradients' segment sums; FM has no ACT
    # site
    "fm": (("segment_sum",), ()),
    "wide_deep": (("segment_sum",), ("quant_pack", "dequant_matmul")),
    "dlrm": (("segment_sum",), ("quant_pack", "dequant_matmul")),
    "xdeepfm": (("segment_sum",), ("quant_pack", "dequant_matmul")),
    # the LMs: the embedding gradient's segment sum; at INT-b each block's
    # saved input (the backward dequantizes it in plain PyTorch, as the
    # reference's jnp does)
    "lm": (("segment_sum",), ("quant_pack",)),
    "moe_lm": (("segment_sum",), ("quant_pack",)),
}

# the reference's defaults (repro/models/registry.py)
DATA_SEED = 2
LR = 3e-3
DIM = 32
N_LAYERS = 3
GNN_LR = 1e-2
GNN_CPU_NODES = 300       # the reference's CPU step: cora_like(n_nodes=300)

RECSYS_LR = 1e-3
RECSYS_DATA_SEED = 3
RECSYS_CPU_BATCH = 256    # the reference's step
RECSYS_CARD_BATCH = 4096  # xDeepFM's published batch (arXiv:1803.05170)
# the training state a table's bytes take: weights, gradient, Adam's two
# moments
RECSYS_TRAIN_COPIES = 4

RECSYS_DP_UNSUPPORTED = (
    "recsys steps have no graph to edge-shard; DLRM-scale "
    "parallelism is embedding-table model parallelism (a "
    "different axis — see launch.partition), not this "
    "edge-sharded DP path")

LM_LR = 1e-3
LM_CPU_BATCH, LM_CPU_SEQ = 8, 64     # the reference's step
LM_CARD_LAYERS = 2                   # depth cut so one card holds the state
LM_CARD_BATCH = 2                    # train_4k's 256 cut to 2
LM_CARD_SEQ = 4096                   # train_4k's sequence

LM_DP_UNSUPPORTED = (
    "the transformer step shards by batch/sequence, not by graph "
    "edges; LM data parallelism needs batch-sharded loss plus "
    "replicated-optimizer wiring the edge-sharded SPMD path does "
    "not provide (use launch.partition's GSPMD cells)")

GNN_DP_UNSUPPORTED = (
    "gcn-cora trains full-graph from dense node features; the "
    "edge-sharded DP path covers the KG entity-embedding steps "
    "(sharded GCN lives in gnn.gcn_forward_spmd via "
    "launch.partition)")


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


def build_step(arch: str, *, device="cuda", **kw) -> ModelStep:
    """The ``ModelStep`` of ``arch`` on ``device``; the keywords are the
    family's (``_kgnn_step``, ``_gnn_step``, ``_recsys_step``)."""
    make = {"gnn": _gnn_step, "recsys": _recsys_step, "lm": _lm_step,
            "moe_lm": _lm_step}.get(family_of(arch), _kgnn_step)
    return make(get(arch), resolve_device(device), **kw)


def family_of(arch: str) -> str:
    """The family of a ported ``arch``; an arch of ``NOT_PORTED`` raises
    ``NotImplementedError`` naming the slice that brings it."""
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"--arch {arch} is not ported yet; it comes with "
            f"{NOT_PORTED[arch]} (ROADMAP Queue 1)")
    return get(arch).family


def _kgnn_step(spec, dev, *, ds=None, cfg=None, batch_size: int = 512,
               graph=None, n_layers: int = N_LAYERS,
               device_graph: bool = True) -> ModelStep:
    """A KG model's BPR step. ``ds``/``cfg`` bring other sizes
    (``n_layers`` sizes the default config); ``graph`` reuses a CKG
    already built on the device. With ``device_graph=False`` no CKG or
    layout is built on the device (the sampled path, ``training.tiering``,
    builds per-batch blocks instead) and ``loss`` raises."""
    from repro_torch.data.synthetic import bpr_batches, gen_kg_dataset
    from repro_torch.models import kgnn

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
                     data={"graph": g, "dataset": ds, "device": dev,
                           "n_edges": len(ds.src)},
                     dp_spec=kg_dp_spec(cfg, ds))


# -- gnn family: gcn-cora node classification ----------------------------------


def gnn_config(shape: str):
    """The GCN config that trains on ``GNN_SHAPES``' ``shape``: the arch's
    own on ``full_graph_sm`` (Cora's 1,433 features, 7 classes),
    ogbn-products' 100 features and 47 classes on ``ogb_products``, and
    the reference's sharded cells' widths elsewhere
    (``repro/launch/partition.py``: Reddit-scale 602 features and 41
    classes on ``minibatch_lg``, 32 features and 2 classes on
    ``molecule``)."""
    spec = get("gcn-cora")
    cfg, p = spec.model_cfg, spec.shape(shape).p()
    if shape == "minibatch_lg":
        return dataclasses.replace(cfg, d_in=602, n_classes=41)
    if shape == "molecule":
        return dataclasses.replace(cfg, d_in=32, n_classes=2)
    return dataclasses.replace(cfg, d_in=p["d_feat"],
                               n_classes=p["n_classes"])


def gnn_data(shape: str, cfg):
    """Host arrays of ``shape`` at ``cfg``'s widths, from seed 0: a
    ``cora_like`` graph ``(feats, src, dst, labels)`` with the ``avg_deg``
    whose edge count comes nearest the shape's, or for ``molecule`` a
    ``molecule_batch`` ``(feats, src, dst, graph_ids, labels)``."""
    from repro_torch.data.synthetic import cora_like, cora_like_avg_deg, \
        molecule_batch

    p = get("gcn-cora").shape(shape).p()
    if shape == "molecule":
        return molecule_batch(n_graphs=p["batch"], n_nodes=p["n_nodes"],
                              n_edges=p["n_edges"], d_feat=cfg.d_in,
                              n_classes=cfg.n_classes)
    avg = cora_like_avg_deg(p["n_nodes"], p["n_edges"], cfg.n_classes)
    return cora_like(n_nodes=p["n_nodes"], d_feat=cfg.d_in,
                     n_classes=cfg.n_classes, avg_deg=avg)


def _gnn_step(spec, dev, *, shape: str | None = None, cfg=None, data=None,
              layout=None, csr=None) -> ModelStep:
    """``gcn-cora``'s step on one of ``GNN_SHAPES`` (default: on the CPU
    the reference's step, the reduced config on ``cora_like(n_nodes=
    300)``; on the card ``full_graph_sm`` at full width). ``cfg`` and
    ``data`` (``gnn_data``'s arrays) bring other sizes; ``layout`` reuses
    a full graph's layout already on ``dev``. ``minibatch_lg`` samples a
    fresh batch of seeds and its blocks each step, from ``DATA_SEED``
    (``csr``: ``data.sampler.build_csr``'s of the graph, when the caller
    has it)."""
    from repro_torch.configs.smoke import reduced
    from repro_torch.data.csr import build_spmm_layout
    from repro_torch.data.sampler import build_csr
    from repro_torch.data.synthetic import cora_like
    from repro_torch.models import gnn

    if shape is None and dev.type == "cpu":
        cfg = cfg or reduced(spec).model_cfg
        if data is None:
            data = cora_like(n_nodes=GNN_CPU_NODES, d_feat=cfg.d_in)
        shape = "full_graph_sm"
    shape = shape or "full_graph_sm"
    kind = spec.shape(shape).kind
    cfg = cfg or gnn_config(shape)
    if data is None:
        data = gnn_data(shape, cfg)
    feats, src, dst = data[:3]
    labels = data[-1]
    x = torch.from_numpy(feats).to(dev)
    y = torch.from_numpy(labels).to(dev)
    n_nodes = x.shape[0]
    # n_edges: the edges a step aggregates over
    out = {"features": x, "labels": y, "device": dev, "shape": shape,
           "n_edges": len(src)}

    def init(seed: int = 0):
        return trainable(gnn.init_params(cfg, seed=seed, device=dev))

    if kind == "minibatch":
        p = spec.shape(shape).p()
        loss, batches = _sampled_gcn(
            cfg, x, y, csr or build_csr(src, dst, n_nodes), dev,
            p["batch_nodes"], p["fanouts"])
        rows, out["n_edges"] = p["batch_nodes"], 0
        for f in p["fanouts"]:          # block h: n_dst * (f + 1) edges
            rows *= f + 1
            out["n_edges"] += rows
    else:
        if layout is None:
            layout = build_spmm_layout(src, dst, n_dst=n_nodes, device=dev)
        out["layout"] = layout
        if kind == "batched_graphs":
            gid = data[3]
            n_graphs = len(labels)
            ids = torch.from_numpy(gid).to(dev)
            runs = gnn.readout_runs(gid, n_graphs, dev)
            out.update(graph_ids=ids, runs=runs)

            def logits(params):
                return gnn.gcn_forward_batched(params, x, layout, ids, runs,
                                               cfg=cfg)
        else:
            def logits(params):
                return gnn.gcn_forward(params, x, layout, cfg=cfg)

        def loss(params, batch, *, ctx=None):
            with enter_or_null(ctx):
                return gnn.node_xent(logits(params), y)

        def batches():
            while True:
                yield {}

    return ModelStep(arch=spec.name, family=spec.family, cfg=cfg, init=init,
                     loss=loss, batches=batches, lr=GNN_LR, data=out,
                     dp_spec=None, dp_unsupported=GNN_DP_UNSUPPORTED)


def _sampled_gcn(cfg, x, y, csr, dev, batch_nodes, fanouts):
    """(loss, batches) of the sampled GCN step: each batch draws
    ``batch_nodes`` seeds and samples their blocks on the host
    (``data.sampler``), with the blocks' layouts. The loss gathers the outermost src set's features
    on the card and runs ``gcn_forward_blocks``."""
    from repro_torch.data.sampler import block_layouts, sample_blocks
    from repro_torch.models import gnn

    n_nodes = x.shape[0]
    indptr, indices = csr

    def loss(params, batch, *, ctx=None):
        h = x.index_select(0, batch["input_nodes"])
        with enter_or_null(ctx):
            logits = gnn.gcn_forward_blocks(params, h, batch["layouts"],
                                            cfg=cfg)
        return gnn.node_xent(logits, y.index_select(0, batch["seeds"]))

    def batches():
        rng = np.random.default_rng(DATA_SEED)
        while True:
            seeds = rng.integers(0, n_nodes, batch_nodes)
            blocks, inp = sample_blocks(indptr, indices, seeds,
                                        list(fanouts), rng=rng)
            yield {"layouts": block_layouts(blocks, dev),
                   "input_nodes": torch.from_numpy(inp).to(dev),
                   "seeds": torch.from_numpy(seeds).to(dev)}

    return loss, batches


# -- recsys family: fm / wide&deep / dlrm / xdeepfm, CTR logistic loss -------


def recsys_config(arch: str, *, row_cap: int | None = None, cfg=None):
    """``cfg`` (default: ``arch``'s full config) with each table capped at
    ``row_cap`` rows (ids past the cap never occur: ``criteo_batches``
    clips each field's zipf ids to its vocabulary)."""
    cfg = cfg or get(arch).model_cfg
    if row_cap is None:
        return cfg
    return dataclasses.replace(cfg, vocab_sizes=tuple(
        min(v, row_cap) for v in cfg.vocab_sizes))


def check_fits(cfg, dev: torch.device, *, copies: int = RECSYS_TRAIN_COPIES,
               name: str | None = None) -> None:
    """Refuse a config whose tables, held ``copies`` times (training:
    weights, gradient and Adam's two moments; serving: 1), would not fit
    the card: ``ValueError`` naming the table's bytes, before anything is
    allocated. Nothing to check on the CPU."""
    if dev.type != "cuda":
        return
    rows = int(sum(cfg.vocab_sizes))
    table = cfg.total_vocab * (cfg.embed_dim + 1) * 4
    need = copies * table
    have = torch.cuda.get_device_properties(dev).total_memory
    if need > have:
        held = (f"training keeps it {copies} times (weights, gradient, two "
                f"Adam moments), " if copies > 1 else "")
        raise ValueError(
            f"{name or cfg.model}: the embedding table holds {rows:,} rows x "
            f"{cfg.embed_dim} x 4 B = {rows * cfg.embed_dim * 4 / 1e9:.1f} GB"
            f" (with the linear term and padding {table / 1e9:.1f} GB); "
            f"{held}{need / 1e9:.1f} GB, more than this card's "
            f"{have / 1e9:.1f} GB. Cap each table's rows (--row-cap N; "
            f"recsys_config(..., row_cap=N)) or shard the table over "
            f"several cards (not ported)")


def _recsys_step(spec, dev, *, cfg=None, batch_size: int | None = None,
                 row_cap: int | None = None) -> ModelStep:
    """A recsys model's CTR step (port of ``repro/models/registry.py:
    _recsys_step``): the mean logistic loss of ``recsys.forward``'s
    logits, batches from ``criteo_batches(seed=3)``, each with its
    ``LookupPlan`` built on the host beside the step. Default config and
    batch: on the CPU the reduced config at 256, on the card the full
    config at 4,096; ``row_cap`` caps the default config's tables
    (``recsys_config``)."""
    from repro_torch.configs.smoke import reduced
    from repro_torch.data.synthetic import criteo_batches
    from repro_torch.models import recsys

    if cfg is None:
        cfg = recsys_config(spec.name, row_cap=row_cap, cfg=(
            reduced(spec).model_cfg if dev.type == "cpu" else None))
    if batch_size is None:
        batch_size = RECSYS_CPU_BATCH if dev.type == "cpu" \
            else RECSYS_CARD_BATCH
    check_fits(cfg, dev, name=spec.name)

    def init(seed: int = 0):
        return trainable(recsys.init_params(cfg, seed=seed, device=dev))

    def loss(params, batch, *, ctx=None):
        with enter_or_null(ctx):
            logits = recsys.forward(params, batch, cfg)
        lab = batch["label"]
        logsig = torch.nn.functional.logsigmoid
        return -torch.mean(lab * logsig(logits) + (1 - lab) * logsig(-logits))

    def batches():
        for b in criteo_batches(batch=batch_size, n_dense=max(cfg.n_dense, 1),
                                vocab_sizes=cfg.vocab_sizes,
                                seed=RECSYS_DATA_SEED):
            out = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            out["lookup"] = recsys.lookup_plan(b["sparse"], cfg, dev)
            yield out

    return ModelStep(arch=spec.name, family="recsys", cfg=cfg, init=init,
                     loss=loss, batches=batches, lr=RECSYS_LR,
                     data={"device": dev, "batch": batch_size},
                     dp_spec=None, dp_unsupported=RECSYS_DP_UNSUPPORTED,
                     unread=("linear", "bias") if cfg.model == "dlrm"
                     else ())


# -- lm / moe_lm families: next-token cross entropy on synthetic streams ------


def lm_config(arch: str):
    """``arch``'s published config (widths, heads, vocabulary, MoE, bf16)
    at ``LM_CARD_LAYERS`` layers: what one card trains and serves."""
    return dataclasses.replace(get(arch).model_cfg, n_layers=LM_CARD_LAYERS)


def _lm_step(spec, dev, *, cfg=None, batch_size: int | None = None,
             seq: int | None = None) -> ModelStep:
    """An LM's step (port of ``repro/models/registry.py:_lm_step``): the
    mean next-token cross entropy (``transformer.lm_loss``) on
    ``lm_batches(seed=0)``, each batch with the embedding's
    ``data.csr.lookup_plan`` built on the host. Default config, batch and
    sequence: on the CPU the reduced config at 8 x 64, on the card
    ``lm_config``'s at ``LM_CARD_BATCH`` x ``LM_CARD_SEQ``."""
    from repro_torch.configs.smoke import reduced
    from repro_torch.data.csr import lookup_plan
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as tf

    cpu = dev.type == "cpu"
    if cfg is None:
        cfg = reduced(spec).model_cfg if cpu else lm_config(spec.name)
    batch_size = batch_size or (LM_CPU_BATCH if cpu else LM_CARD_BATCH)
    seq = seq or (LM_CPU_SEQ if cpu else LM_CARD_SEQ)

    def init(seed: int = 0):
        return trainable(tf.init_params(cfg, seed=seed, device=dev))

    def loss(params, batch, *, ctx=None):
        with enter_or_null(ctx):
            return tf.lm_loss(params, batch, cfg)

    def batches():
        for b in lm_batches(vocab=cfg.vocab, batch=batch_size, seq=seq,
                            seed=0):
            yield {"tokens": torch.from_numpy(b["tokens"]).to(dev),
                   "lookup": lookup_plan(b["tokens"][:, :-1], cfg.vocab,
                                         dev)}

    return ModelStep(arch=spec.name, family=spec.family, cfg=cfg, init=init,
                     loss=loss, batches=batches, lr=LM_LR,
                     data={"device": dev, "batch": batch_size, "seq": seq},
                     dp_spec=None, dp_unsupported=LM_DP_UNSUPPORTED)


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
    """The kernels a training step of ``model`` (a KG model, ``gcn``, a
    recsys ``RecsysConfig.model``, or ``lm``/``moe_lm``) launches, with
    INT-b sites (``packed``) or at FP32."""
    fp32, more = PATH_KERNELS[model]
    return fp32 + (more if packed else ())


def archs() -> list[str]:
    """Every ``--arch`` the launcher accepts (ported or not)."""
    return sorted(set(ARCHS) | set(NOT_PORTED))
