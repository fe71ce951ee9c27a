"""The paper's KGNN configs (section 4.1.4: dim 64, 3 layers, Amazon-Book
scale); port of ``repro/configs/kgnn_paper.py``."""

from repro_torch.models.kgnn import KGNNConfig

from .base import ArchSpec, _s

# Amazon-Book statistics from paper Table 1
_AB = dict(n_users=70679, n_entities=88572 + 24915, n_relations=2 * 39 + 2)

# the synthetic graphs of that size (data.synthetic): the latent-factor CKG
# the full-graph paths train and serve on, and the zipf-skewed one of the
# sampled path (hot/cold tiering; paper-scale node and relation counts)
AMAZON_BOOK_CKG = dict(n_users=70679, n_items=24915, n_attrs=88572,
                       n_relations=39, n_triples=2557746, inter_per_user=12,
                       seed=0)
AMAZON_BOOK_ZIPF = dict(AMAZON_BOOK_CKG, zipf_a=1.1)

_KG_SHAPES = (
    _s("paper_full", "kgnn_train", n_triples=2 * 2557746 + 2 * 847733,
       batch=1024),
    _s("bench_small", "kgnn_train", n_triples=40000, batch=1024),
)

KGAT = ArchSpec(
    name="kgat", family="kgnn", source="arXiv:1905.07854 / paper §4.1.2",
    model_cfg=KGNNConfig(model="kgat", dim=64, n_layers=3, n_bases=4,
                         readout="concat", **_AB),
    shapes=_KG_SHAPES,
)
KGCN = ArchSpec(
    name="kgcn", family="kgnn", source="KGNN-LS arXiv:1905.04413",
    model_cfg=KGNNConfig(model="kgcn", dim=64, n_layers=3, readout="sum",
                         **_AB),
    shapes=_KG_SHAPES,
)
KGIN = ArchSpec(
    name="kgin", family="kgnn", source="arXiv:2102.07057",
    model_cfg=KGNNConfig(model="kgin", dim=64, n_layers=3, n_intents=4,
                         readout="sum", **_AB),
    shapes=_KG_SHAPES,
)
