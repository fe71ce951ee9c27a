"""The four recsys architectures with realistic vocabularies (port of
``repro/configs/recsys_archs.py``).

dlrm-mlperf uses the canonical MLPerf Criteo-1TB table sizes (26 tables,
187,767,399 rows in all). xdeepfm and fm use the 26 public Criteo-Kaggle
field cardinalities plus 13 bucketized dense fields, 39 sparse fields.
wide-deep uses 40 fields mixing user, context and item vocabularies, as
the paper's app-store setting.
"""

from repro_torch.models.recsys import RecsysConfig

from .base import RECSYS_SHAPES, ArchSpec

# MLPerf DLRM (Criteo Terabyte, day-based, capped at 40M rows a table)
_MLPERF_TABLES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36)

# Criteo-Kaggle categorical cardinalities (26 fields, public statistics)
_KAGGLE_TABLES = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)
_DENSE_BUCKETS = (128,) * 13  # bucketized dense -> 13 small categorical
_KAGGLE39 = _KAGGLE_TABLES + _DENSE_BUCKETS

# wide&deep (Google Play setting): 40 fields, a few huge id spaces (user,
# item, developer), the rest small demographics and context
_WD_TABLES = (10_000_000, 2_000_000, 500_000, 100_000) + (10_000,) * 8 + \
    (1_000,) * 12 + (100,) * 16

WIDE_DEEP = ArchSpec(
    name="wide-deep",
    family="recsys",
    source="arXiv:1606.07792",
    model_cfg=RecsysConfig(
        model="wide_deep", n_sparse=40, vocab_sizes=_WD_TABLES,
        embed_dim=32, mlp=(1024, 512, 256), interaction="concat"),
    shapes=RECSYS_SHAPES,
)

DLRM_MLPERF = ArchSpec(
    name="dlrm-mlperf",
    family="recsys",
    source="arXiv:1906.00091 (MLPerf config)",
    model_cfg=RecsysConfig(
        model="dlrm", n_sparse=26, vocab_sizes=_MLPERF_TABLES,
        embed_dim=128, n_dense=13, bot_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1), interaction="dot"),
    shapes=RECSYS_SHAPES,
)

XDEEPFM = ArchSpec(
    name="xdeepfm",
    family="recsys",
    source="arXiv:1803.05170",
    model_cfg=RecsysConfig(
        model="xdeepfm", n_sparse=39, vocab_sizes=_KAGGLE39,
        embed_dim=10, cin_layers=(200, 200, 200), mlp=(400, 400),
        interaction="cin"),
    shapes=RECSYS_SHAPES,
)

FM = ArchSpec(
    name="fm",
    family="recsys",
    source="Rendle ICDM'10",
    model_cfg=RecsysConfig(
        model="fm", n_sparse=39, vocab_sizes=_KAGGLE39, embed_dim=10,
        interaction="fm-2way"),
    shapes=RECSYS_SHAPES,
)
