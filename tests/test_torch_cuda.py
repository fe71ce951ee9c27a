"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs an NVIDIA Hopper GPU and nvcc, and skips
without them (the kernels have no CPU or interpret mode). Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Small shapes; ``chip_smoke.py`` repeats the checks at the serving and
training paths' full-width shapes.
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.configs.smoke import reduced
from repro_torch.core.quant import QTensor, dequantize, pack_bits, quantize
from repro_torch.data.csr import SEG_CHUNK, build_spmm_layout, \
    relation_runs, segment_runs
from repro_torch.core.policy import schedule_from_cli
from repro_torch.kernels import autotune, backend
from repro_torch.kernels import dequant_matmul as dq
from repro_torch.kernels import ops
from repro_torch.kernels import quant_pack as qp
from repro_torch.kernels import spmm as sp
from repro_torch.kernels import topk_score as tk
from repro_torch.launch.serve import reduced_dataset, serve_kgnn
from repro_torch.launch.train import train_kgnn
from repro_torch.models import kgnn
from repro_torch.models.layers import param_leaves
from repro_torch.obs.profiling import profiled_kernels
from repro_torch.models.registry import arch_of, build_step, model_config, \
    path_kernels
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scorer import quantize_query, two_stage_topk
from repro_torch.serving.store import QuantizedEmbeddingStore
from repro_torch.training.optimizer import adam
from repro_torch.training.step import make_train_step, step_metadata, \
    trainable
from repro_torch.training.trainer import Trainer, TrainerConfig

SERVING = ("quant_pack", "spmm", "topk_score")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU and nvcc: the CUDA kernels "
                    "have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _empty_tile_cache(tmp_path):
    """Every card test runs the top-K and coarse kernels at the planner's
    query tile: the autotuner reads an empty cache of its own and never
    sweeps (a cache left in the checkout would change the plans the tests
    hold the launches to)."""
    if torch.cuda.is_available():
        autotune.reset(str(tmp_path / "autotune.json"), sweep=False)
    yield
    autotune.reset()


QP_WIDTHS = [1, 3, 5, 16, 31, 32, 33, 37, 64, 100, 129, 602, 1433, 12288,
             40000]


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("d", QP_WIDTHS)
@pytest.mark.parametrize("rows", ["301", "1", "7", "tile-1", "tile+1",
                                  "slice"])
def test_quant_pack_kernel_bit_identical(cuda, bits, stochastic, d, rows):
    """Codes, scale and zero bit-identical to the plain version, and two
    calls bit-identical, at the widths on the edges of the kernel's routes
    (lanes a row 1-32, packs of 1-4 bytes a word, rows of whole words or
    not, a row wider than a stage: 12,288, and wider than the ring: 40,000,
    a warp a row) at 301, 1 and 7 rows (small tables take the warp-a-row
    route), at a multiple of a tile's rows - 1 and + 1 (the tile route, its
    last tile of T - 1 rows or of one), and on a misaligned base of that
    size (``x[1:]`` of a table: at an odd width its base sits 4 bytes off
    16). A constant row (R = 0) in every table of more than 5 rows."""
    big = qp.quant_pack_plan(1 << 22, d, bits=bits, stochastic=stochastic)
    n = {"301": 301, "1": 1, "7": 7}.get(rows)
    if n is None:
        t = big["rows_a_tile"] if big["route"] == "tiles" else 1
        n = t * 1024 + (-1 if rows == "tile-1" else 1)
        plan = qp.quant_pack_plan(n, d, bits=bits, stochastic=stochastic)
        assert plan["route"] == big["route"]
        assert plan["rows_a_tile"] == big["rows_a_tile"]
    gen = torch.Generator(device=cuda).manual_seed(bits * 7 + d)
    x = torch.randn((n + (rows == "slice"), d), generator=gen, device=cuda)
    if rows == "slice":
        x = x[1:]
        assert x.is_contiguous()
    if n > 5:
        x[5] = 0.5                                        # R == 0
    got = qp.quant_pack_cuda(x, 99, bits=bits, stochastic=stochastic)
    again = qp.quant_pack_cuda(x, 99, bits=bits, stochastic=stochastic)
    ref = qp.quant_pack_plain(x, 99, bits=bits, stochastic=stochastic)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, r)
        assert torch.equal(g, a)


def _layout(cuda, n_src, n_dst, n_edges, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, n_edges)
    dst = np.minimum(rng.zipf(1.5, n_edges) - 1, 2 * n_dst // 3)
    return build_spmm_layout(src, dst, n_dst=n_dst, n_src=n_src, block_e=32,
                             block_rows=16, device=cuda)


def _skewed_layout(cuda, seed):
    """Both directions zipf-skewed: rows of more than 256 slots, rows of
    33-256, short rows and empty rows, and tiles of very different sizes."""
    rng = np.random.default_rng(seed)
    src = np.minimum(rng.zipf(1.3, 6000) - 1, 300)
    dst = np.minimum(rng.zipf(1.5, 6000) - 1, 466)
    return build_spmm_layout(src, dst, n_dst=700, n_src=500, block_e=32,
                             block_rows=16, device=cuda)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("d", [1, 3, 64, 200])
def test_spmm_kernel_close_and_deterministic(cuda, transpose, weighted, d):
    layout = _skewed_layout(cuda, d)
    m, dr = layout.meta, layout.direction(transpose)
    deg = (dr.row_end - dr.row_start).cpu()
    assert int(deg.max()) > 256 and bool(((deg > 32) & (deg <= 256)).any())
    assert bool((deg == 0).any())
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((m.n_dst if transpose else m.n_src, d), generator=gen,
                    device=cuda)
    ew = torch.rand(m.n_edges, generator=gen, device=cuda) \
        if weighted else None
    a = sp.spmm_cuda(x, ew, layout, transpose=transpose)
    b = sp.spmm_cuda(x, ew, layout, transpose=transpose)
    ref = sp.spmm_plain(x, ew, layout, transpose=transpose)
    assert torch.equal(a, b)
    assert float((a - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert bool((a[deg == 0] == 0).all())


@pytest.mark.parametrize("d", [64, 4])
def test_spmm_kernel_unaligned_table(cuda, d):
    """A table that does not start on 16 bytes takes the scalar columns."""
    layout = _skewed_layout(cuda, 7)
    m = layout.meta
    gen = torch.Generator(device=cuda).manual_seed(7)
    buf = torch.randn(m.n_src * d + 1, generator=gen, device=cuda)
    x = buf[1:].view(m.n_src, d)
    assert x.data_ptr() % 16 != 0
    ew = torch.rand(m.n_edges, generator=gen, device=cuda)
    a = sp.spmm_cuda(x, ew, layout)
    assert torch.equal(a, sp.spmm_cuda(x, ew, layout))
    ref = sp.spmm_plain(x, ew, layout)
    assert float((a - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.parametrize("bits,dim", [(8, 256), (4, 64), (2, 37)])
@pytest.mark.parametrize("b", [1, 8, 45])
def test_topk_kernel_ties_bit_identical(cuda, bits, dim, b):
    gen = torch.Generator(device=cuda).manual_seed(bits + b)
    n_items, k = 1000, 20
    codes = torch.randint(0, min(4, 2**bits), (n_items, dim), generator=gen,
                          device=cuda).to(torch.uint8)
    items = QTensor(pack_bits(codes, bits),
                    torch.ones((n_items, 1), device=cuda),
                    torch.zeros((n_items, 1), device=cuda), bits, dim)
    q = torch.randint(-2, 3, (b, dim), generator=gen,
                      device=cuda).to(torch.float32)
    excl = torch.randint(-1, n_items, (b, 7), generator=gen, device=cuda,
                         dtype=torch.int32)
    kv, ki = tk.topk_cuda(q, items, excl, k=k)
    pv, pi = tk.topk_plain(q, items, excl, k=k, block_i=128)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


def test_topk_kernel_random_and_dense(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    n_items, d, b, k = 3001, 96, 16, 33
    table = torch.randn((n_items, d), generator=gen, device=cuda)
    q = torch.randn((b, d), generator=gen, device=cuda)
    excl = torch.full((b, 2), -1, dtype=torch.int32, device=cuda)
    for items in (quantize(table, 0, bits=8), table):
        kv, ki = tk.topk_cuda(q, items, excl, k=k)
        pv, pi = tk.topk_plain(q, items, excl, k=k)
        scale = float(pv.abs().max())
        assert float((kv - pv).abs().max()) <= 1e-5 * scale
        swapped = ki != pi
        assert bool(((kv - pv).abs()[swapped] <= 1e-5 * scale).all())
        xhat = dequantize(items) if isinstance(items, QTensor) else items
        assert float((torch.gather(q @ xhat.T, 1, ki.long()) - kv)
                     .abs().max()) <= 1e-5 * scale


def test_reduced_serving_path_runs_the_kernels(cuda):
    cfg = reduced(get("kgat")).model_cfg
    ds = reduced_dataset(cfg)
    ref = kgnn.propagate(kgnn.init_params(cfg, device="cpu"),
                         ds.graph("cpu"), cfg)
    got = kgnn.propagate(kgnn.init_params(cfg, device=cuda),
                         ds.graph(cuda), cfg)
    assert float((got.cpu() - ref).abs().max()) <= 1e-5
    backend.reset_counts()
    res = serve_kgnn(cfg, ds, kgnn.init_params(cfg, device=cuda), bits=8,
                     k=10, requests=12, device=cuda, log=lambda _: None)
    counts = dict(backend.LAUNCH_COUNTS)
    assert all(counts.get(n, 0) > 0 for n in SERVING), counts
    assert res["dense_delta"] <= 1e-6


def _rel(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


def _long_row_layout(cuda, seed):
    """Zipf-skewed destinations (pad slots, empty tiles) plus one row of
    12,000 more slots: a run far longer than any batch of the kernels."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 500, 18000)
    dst = np.minimum(rng.zipf(1.5, 18000) - 1, 466)
    dst[6000:] = 5
    return build_spmm_layout(src, dst, n_dst=700, n_src=500, block_e=32,
                             block_rows=16, device=cuda)


@pytest.mark.parametrize("x_off", [0, 4])
@pytest.mark.parametrize("d", [1, 37, 64, 200])
def test_sddmm_kernel_close_and_deterministic(cuda, d, x_off):
    """Rows of every length up to 12,000+ slots; ``x_off`` 4 starts x off
    a 16-byte boundary (the scalar columns)."""
    layout = _long_row_layout(cuda, d)
    m = layout.meta
    assert bool((layout.perm_blk == m.n_edges).any())
    assert int((layout.row_end - layout.row_start).max()) > 10000
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = _shifted(torch.randn((m.n_src, d), generator=gen, device=cuda),
                 x_off)
    assert (x.data_ptr() % 16 != 0) == (x_off > 0)
    g = torch.randn((m.n_dst, d), generator=gen, device=cuda)
    a = sp.sddmm_cuda(x, g, layout)
    assert torch.equal(a, sp.sddmm_cuda(x, g, layout))
    assert _rel(a, sp.sddmm_plain(x, g, layout)) <= 1e-5


@pytest.mark.parametrize("kind", ["dst", "src", "rel"])
@pytest.mark.parametrize("d", [1, 4, 37, 64])
def test_segment_sum_kernel_close_and_deterministic(cuda, kind, d):
    """The gathers' backward on zipf-skewed groupings (empty rows, runs of
    256+ slots; relations chunked into three levels) against the plain
    route, and the same bits twice."""
    layout = _skewed_layout(cuda, d)
    m = layout.meta
    if kind == "rel":
        rng = np.random.default_rng(d)
        rel = np.minimum(rng.zipf(1.3, m.n_edges) - 1, 9)
        levels = relation_runs(rel, 12, chunk=16, device=cuda)
        assert len(levels) == 3
    else:
        levels = layout.runs(transpose=kind == "src")
    deg = (levels[-1].row_end - levels[-1].row_start).cpu()
    assert bool((deg == 0).any())
    if kind != "rel":
        assert int(deg.max()) > 256
    gen = torch.Generator(device=cuda).manual_seed(d)
    y = torch.randn((m.n_edges, d), generator=gen, device=cuda)
    backend.reset_counts()
    a = sp.segment_sum_cuda(y, levels)
    assert backend.LAUNCH_COUNTS["segment_sum"] == len(levels)
    assert torch.equal(a, sp.segment_sum_cuda(y, levels))
    ref = sp.segment_sum_plain(y, levels)
    assert _rel(a, ref) <= 1e-5
    assert bool((a[deg == 0] == 0).all())


def _contract_sum(levels, y: np.ndarray) -> np.ndarray:
    """numpy model of the segment-sum kernel's order: each run cut into
    chunks of SEG_CHUNK slots at run-relative offsets, each chunk summed in
    slot order with float32 adds from 0, a row's chunk sums then added in
    chunk order from 0."""
    c = SEG_CHUNK

    def seq(rows):
        z = np.zeros((1,) + rows.shape[1:], np.float32)
        return np.cumsum(np.concatenate([z, rows]), axis=0,
                         dtype=np.float32)[-1]

    for runs in levels:
        perm = runs.perm.cpu().numpy().astype(np.int64)
        rs = runs.row_start.cpu().numpy().astype(np.int64)
        re = runs.row_end.cpu().numpy().astype(np.int64)
        out = np.zeros((runs.n_out,) + y.shape[1:], np.float32)
        for r in range(runs.n_out):
            parts = [seq(y[perm[a:min(a + c, re[r])]])
                     for a in range(rs[r], re[r], c)]
            if parts:
                out[r] = parts[0] if len(parts) == 1 else seq(np.stack(parts))
        y = out
    return y


def _chunk_groupings(cuda):
    """Levels for the segment-sum kernel: runs of exactly C and C + 1
    slots, one of 10C + 3 and one of 40C, empty and short rows, pad gaps
    between runs (one level); a zipf layout's runs by destination and by
    source; relations chunked into three levels."""
    c = SEG_CHUNK
    rng = np.random.default_rng(11)
    lens = np.concatenate([[0, 1, c, c + 1, 0, 0, 10 * c + 3, 5, 0, 40 * c],
                           rng.integers(0, 40, 2000), [c, 0]])
    gaps = np.where(rng.random(len(lens)) < 0.2,
                    rng.integers(1, 40, len(lens)), 0)
    start = np.cumsum(np.concatenate([[0], (lens + gaps)[:-1]]))
    n_rows = int(lens.sum())
    perm = np.full(int(start[-1] + lens[-1]), n_rows)
    for a, n, v in zip(start, lens, np.split(rng.permutation(n_rows),
                                             np.cumsum(lens)[:-1])):
        perm[a:a + n] = v
    layout = _skewed_layout(cuda, 0)
    rel = np.minimum(rng.zipf(1.3, layout.meta.n_edges) - 1, 9)
    return {"chunks": (segment_runs(perm, start, start + lens, len(lens),
                                    n_rows, cuda),),
            "dst": layout.runs(), "src": layout.runs(transpose=True),
            "rel": relation_runs(rel, 12, chunk=16, device=cuda)}


@pytest.mark.parametrize("kind", ["chunks", "dst", "src", "rel"])
@pytest.mark.parametrize("d", [1, 4, 64, 65])
def test_segment_sum_kernel_is_chunk_contract(cuda, kind, d):
    """The kernel equals, bit for bit, the numpy model of its chunk-order
    contract (d 65: unaligned, scalar columns); the same bits twice; one
    launch count a level, and the CUDA kernels each level started, as the
    entry point counts them at launch: one, two where the level has a run
    longer than a chunk."""
    levels = _chunk_groupings(cuda)[kind]
    if kind == "chunks":
        deg = (levels[0].row_end - levels[0].row_start).cpu()
        assert int(deg.max()) >= 10 * SEG_CHUNK and bool((deg == 0).any())
    rng = np.random.default_rng(d)
    y_np = rng.normal(size=(levels[0].n_rows, d)).astype(np.float32)
    y = torch.from_numpy(y_np).to(cuda)
    backend.reset_counts()
    a = sp.segment_sum_cuda(y, levels)
    assert backend.LAUNCH_COUNTS["segment_sum"] == len(levels)
    assert backend.CUDA_KERNEL_COUNTS["segment_sum"] == sum(
        1 + (lv.plan.n_parts > 0) for lv in levels)
    assert torch.equal(a, sp.segment_sum_cuda(y, levels))
    np.testing.assert_array_equal(a.cpu().numpy(), _contract_sum(levels, y_np))
    x = y
    for lv in levels:
        backend.reset_counts()
        x = sp.segment_sum_cuda(x, (lv,))
        assert backend.CUDA_KERNEL_COUNTS["segment_sum"] == \
            1 + (lv.plan.n_parts > 0)


@pytest.mark.parametrize("d", [1, 4, 64])
def test_segment_sum_short_runs_equal_spmm_route(cuda, d):
    """Where no run is longer than a chunk (the relation levels) the kernel
    gives the bits of the route it replaced, the SPMM kernel with gat :=
    perm and no weights, which sums each run whole in slot order."""
    levels = _chunk_groupings(cuda)["rel"]
    assert all(lv.plan.n_parts == 0 for lv in levels)
    gen = torch.Generator(device=cuda).manual_seed(d)
    y = torch.randn((levels[0].n_rows, d), generator=gen, device=cuda)
    fn = backend.kernel_fn("spmm", "spmm_launch", sp._ARGTYPES)
    old = y
    for runs in levels:
        out = torch.empty((runs.n_out, d), device=cuda)
        backend.launch(fn, old.data_ptr(), d, None, runs.perm.data_ptr(),
                       runs.perm.data_ptr(), runs.row_start.data_ptr(),
                       runs.row_end.data_ptr(), runs.n_out, out.data_ptr(),
                       backend.stream_of(old))
        old = out
    assert torch.equal(sp.segment_sum_cuda(y, levels), old)


def _clone_state(state):
    def c(v):
        if isinstance(v, torch.Tensor):
            return v.detach().clone().requires_grad_(v.requires_grad)
        if isinstance(v, (list, tuple)):
            return type(v)(c(t) for t in v)
        if isinstance(v, dict):
            return {k: c(t) for k, t in v.items()}
        return v

    return c(state)


@pytest.mark.parametrize("bits", [0, 2])
def test_two_training_steps_bit_identical(cuda, bits):
    """Two steps from the same parameters, optimizer state and batch give
    the same loss and parameters bit for bit, without
    ``torch.use_deterministic_algorithms``: no sum of the step depends on
    the order of atomics."""
    assert not torch.are_deterministic_algorithms_enabled()
    cfg = reduced(get("kgat")).model_cfg
    ds = reduced_dataset(cfg)
    step = build_step(cfg.model, ds=ds, cfg=cfg, batch_size=32, device=cuda)
    opt = adam(step.lr)
    params = trainable(step.init(0))
    state = (params, opt.init(params))
    batch = next(step.batches())
    train = make_train_step(step, opt, schedule=schedule_from_cli(None, bits),
                            root_seed=1)
    state, _ = train(state, batch, 0)                 # moments not zero
    runs = [train(_clone_state(state), batch, 1) for _ in range(2)]
    (p1, o1), m1 = runs[0]
    (p2, o2), m2 = runs[1]
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(param_leaves(p1) + o1["mu"] + o1["nu"],
                    param_leaves(p2) + o2["mu"] + o2["nu"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("dim", [64, 37, 200])
def test_dequant_sddmm_kernel_close_and_deterministic(cuda, bits, dim):
    layout = _layout(cuda, 500, 700, 6000, bits + dim)
    m = layout.meta
    gen = torch.Generator(device=cuda).manual_seed(bits)
    q = quantize(torch.randn((m.n_src, dim), generator=gen, device=cuda),
                 5, bits=bits, stochastic=True)
    g = torch.randn((m.n_dst, dim), generator=gen, device=cuda)
    a = sp.dequant_sddmm_cuda(q, g, layout)
    assert torch.equal(a, sp.dequant_sddmm_cuda(q, g, layout))
    assert _rel(a, sp.dequant_sddmm_plain(q, g, layout)) <= 1e-5


def _shifted(t, nbytes):
    """A contiguous copy of ``t`` whose storage starts ``nbytes`` past a
    16-byte boundary."""
    n = nbytes // t.element_size()
    buf = torch.empty(t.numel() + n, dtype=t.dtype, device=t.device)
    out = buf[n:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("packed_off,g_off", [(1, 0), (8, 0), (0, 4)])
def test_dequant_sddmm_kernel_unaligned_tables(cuda, bits, packed_off,
                                               g_off):
    """Tables that break the 16-byte alignment of the vector loads take the
    byte-wise walk, which sums in the same order: the same bits."""
    layout = _layout(cuda, 500, 700, 6000, bits)
    m = layout.meta
    gen = torch.Generator(device=cuda).manual_seed(bits)
    q = quantize(torch.randn((m.n_src, 64), generator=gen, device=cuda),
                 5, bits=bits, stochastic=True)
    g = torch.randn((m.n_dst, 64), generator=gen, device=cuda)
    q2 = QTensor(_shifted(q.packed, packed_off), q.scale, q.zero, bits, 64)
    g2 = _shifted(g, g_off)
    assert (q2.packed.data_ptr() % 16 != 0) == (packed_off > 0)
    assert (g2.data_ptr() % 16 != 0) == (g_off > 0)
    assert torch.equal(sp.dequant_sddmm_cuda(q2, g2, layout),
                       sp.dequant_sddmm_cuda(q, g, layout))


def _dqmm_table(cuda, table, rows, dim, n, seed):
    """x and g for the dequant-matmul: random; rows offset far from 0 (x =
    4 + 0.05 randn: the zero term dominates); rows centred on 0 with g of
    mixed sign (the code and zero terms of an uncentred split cancel)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((rows, dim), generator=gen, device=cuda)
    if table == "offset":
        x = 4.0 + 0.05 * x
    elif table == "cancel":
        x = 0.1 * x
    return x, torch.randn((rows, n), generator=gen, device=cuda)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("rows,dim,n", [(0, 64, 64), (1, 64, 64),
                                        (63, 37, 24), (65, 64, 64),
                                        (4099, 64, 64), (1000, 37, 24),
                                        (70000, 130, 70)])
@pytest.mark.parametrize("table", ["randn", "offset", "cancel"])
def test_dequant_matmul_kernel_close_and_deterministic(cuda, bits, rows,
                                                       dim, n, table):
    """Within 1e-5 of the plain version, the same bits twice, and the same
    bits again from a packed table 1 byte and a g 4 bytes off 16-byte
    alignment (byte loads of the codes and 4-byte copies of g stage the
    same values as the 16-byte copies)."""
    x, g = _dqmm_table(cuda, table, rows, dim, n, rows + bits)
    q = quantize(x, 3, bits=bits, stochastic=True)
    a = dq.dequant_matmul_cuda(q, g)
    assert a.shape == (dim, n)
    assert torch.equal(a, dq.dequant_matmul_cuda(q, g))
    ref = dq.dequant_matmul_plain(q, g)
    if rows == 0:
        assert torch.equal(a, torch.zeros_like(a))
    else:
        assert _rel(a, ref) <= 1e-5
    q2 = QTensor(_shifted(q.packed, 1), q.scale, q.zero, bits, dim)
    g2 = _shifted(g, 4)
    assert rows == 0 or (q2.packed.data_ptr() % 16 != 0
                         and g2.data_ptr() % 16 != 0)
    assert torch.equal(dq.dequant_matmul_cuda(q2, g2), a)


@pytest.mark.parametrize("bits", [0, 2])
def test_reduced_training_runs_the_kernels(cuda, bits):
    """A few reduced KGAT steps on the card follow the CPU's plain versions;
    every kernel of the schedule's path launches."""
    cfg = reduced(get("kgat")).model_cfg
    ds = reduced_dataset(cfg)
    sched = schedule_from_cli(None, bits)
    runs = {}
    for dev in ("cpu", cuda):
        backend.reset_counts()
        runs[str(dev)] = train_kgnn(
            cfg, ds, kgnn.init_params(cfg, device=dev), sched, 3, batch=32,
            device=dev, log=lambda _: None)
    launches = runs[str(cuda)]["steps"][0]["launches"]
    assert all(launches.get(k, 0) > 0
               for k in path_kernels("kgat", bool(bits))), launches
    losses = [[r["loss"] for r in run["steps"]] for run in runs.values()]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


@pytest.mark.parametrize("model", ["kgcn", "kgin", "rgcn"])
def test_reduced_kg_models_run_the_kernels_and_repeat(cuda, model):
    """Three reduced INT2 steps of KGCN, KGIN and R-GCN on the card follow
    the CPU's plain versions, launch their path's kernels, and two steps
    from one state give the same bits."""
    cfg = model_config(model, lambda a: reduced(get(a)))
    ds = reduced_dataset(cfg)
    sched = schedule_from_cli(None, 2)
    runs = {}
    for dev in ("cpu", cuda):
        runs[str(dev)] = train_kgnn(
            cfg, ds, kgnn.init_params(cfg, device=dev), sched, 3, batch=32,
            device=dev, log=lambda _: None)
    launches = runs[str(cuda)]["steps"][0]["launches"]
    assert all(launches.get(k, 0) > 0
               for k in path_kernels(model, packed=True)), launches
    losses = [[r["loss"] for r in run["steps"]] for run in runs.values()]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)

    step = build_step(arch_of(model), ds=ds, cfg=cfg, batch_size=32,
                      device=cuda)
    opt = adam(step.lr)
    params = trainable(step.init(0))
    batch = next(step.batches())
    train = make_train_step(step, opt, schedule=sched, root_seed=1)
    state, _ = train((params, opt.init(params)), batch, 0)
    (p1, o1), m1 = train(_clone_state(state), batch, 1)
    (p2, o2), m2 = train(_clone_state(state), batch, 1)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(param_leaves(p1) + o1["mu"] + o1["nu"],
                    param_leaves(p2) + o2["mu"] + o2["nu"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [0, 2])
def test_replayed_step_bit_identical_on_card(cuda, tmp_path, bits):
    """Step 3 from the step-2 checkpoint, restored from disk into a fresh
    trainer on the card, on step 3's batch: the same loss, parameters and
    Adam moments as the uninterrupted run, bit for bit."""
    cfg = reduced(get("kgat")).model_cfg
    step = build_step("kgat", ds=reduced_dataset(cfg), cfg=cfg,
                      batch_size=32, device=cuda)
    opt = adam(step.lr)
    train = make_train_step(step, opt, schedule=schedule_from_cli(None, bits),
                            root_seed=1)
    batches = [b for _, b in zip(range(3), step.batches())]

    def trainer(name, data):
        p = trainable(step.init(0))
        return Trainer(train, (p, opt.init(p)), iter(data),
                       TrainerConfig(total_steps=3, ckpt_every=2,
                                     ckpt_dir=str(tmp_path / name)),
                       ckpt_meta=step_metadata(step, f"int{bits}"),
                       log_fn=lambda _: None)

    first = trainer("a", batches)
    p1, o1 = first.run()
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_0000000002",
                    tmp_path / "b" / "step_0000000002")
    replay = trainer("b", batches[2:]).restore_if_available()
    assert replay.step == 2
    p2, o2 = replay.run()
    assert replay.history[0]["loss"] == first.history[2]["loss"]
    assert o1["step"] == o2["step"] == 3
    for a, b in zip(param_leaves(p1) + o1["mu"] + o1["nu"],
                    param_leaves(p2) + o2["mu"] + o2["nu"]):
        assert a.is_cuda and torch.equal(a, b)


N_COARSE = 3001                  # not a multiple of the 128-item chunk


def _coarse_case(cuda, case, bits, dim):
    gen = torch.Generator(device=cuda).manual_seed(bits * 100 + dim)
    b = 45
    if case == "ties":
        codes = torch.randint(0, 4, (N_COARSE, dim), generator=gen,
                              device=cuda).to(torch.uint8)
        items = QTensor(pack_bits(codes, bits),
                        torch.ones((N_COARSE, 1), device=cuda),
                        torch.zeros((N_COARSE, 1), device=cuda), bits, dim)
        q = torch.randint(-2, 3, (b, dim), generator=gen,
                          device=cuda).to(torch.float32)
    else:                                   # random, padded packs included
        items = quantize(torch.randn((N_COARSE, dim), generator=gen,
                                     device=cuda), 0, bits=bits)
        q = torch.randn((b, dim), generator=gen, device=cuda)
    q8, qmeta = quantize_query(q)
    excl = torch.randint(-1, N_COARSE, (b, 9), generator=gen, device=cuda,
                         dtype=torch.int32)
    return q8, qmeta, items, excl


@pytest.mark.parametrize("case,bits,dim", [("ties", 8, 64),
                                           ("random", 8, 256),
                                           ("random", 4, 64),
                                           ("padded", 4, 37),
                                           ("padded", 2, 37)])
@pytest.mark.parametrize("m", [1, 80, 128, 129, 1000, N_COARSE])
def test_coarse_kernel_bit_identical(cuda, case, bits, dim, m):
    q8, qmeta, items, excl = _coarse_case(cuda, case, bits, dim)
    kv, ki = tk.coarse_topm_cuda(q8, qmeta, items, excl, m=m)
    pv, pi = tk.coarse_topm_plain(q8, qmeta, items, excl, m=m)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    if m < N_COARSE - 9:
        assert not bool((ki[:, :, None] == excl[:, None, :]).any())


@pytest.mark.parametrize("k", [129, 500])
def test_topk_kernel_large_k_bit_identical(cuda, k):
    q8, _, items, excl = _coarse_case(cuda, "ties", 8, 64)
    kv, ki = tk.topk_cuda(q8, items, excl, k=k)
    pv, pi = tk.topk_plain(q8, items, excl, k=k)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


N_RAGGED = 1001                  # 7 full item tiles and a tail of 105


def _ragged_case(cuda, b, bits, dim, seed, n_items=N_RAGGED):
    """Integer-valued queries and codes (every dot exact, ties everywhere),
    ragged in B and I; row 0's exclusions repeat ids, row 1's remove the
    whole second item tile (ids 128-255), the rest are random with -1 pads."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    codes = torch.randint(0, min(4, 2**bits), (n_items, dim), generator=gen,
                          device=cuda).to(torch.uint8)
    items = QTensor(pack_bits(codes, bits),
                    torch.ones((n_items, 1), device=cuda),
                    torch.zeros((n_items, 1), device=cuda), bits, dim)
    q = torch.randint(-2, 3, (b, dim), generator=gen,
                      device=cuda).to(torch.float32)
    excl = torch.randint(-1, n_items, (b, 130), generator=gen, device=cuda,
                         dtype=torch.int32)
    excl[:, 12:] = -1
    excl[0, :12] = torch.tensor([5, 5, 5, 900, 900, 0, 0, 1000, 1000, 17,
                                 17, 5], dtype=torch.int32, device=cuda)
    if b > 1:
        excl[1, :128] = torch.arange(128, 256, dtype=torch.int32,
                                     device=cuda)
    return q, items, excl


def _run_twice(fn):
    """Two runs of a kernel: they must agree bit for bit."""
    v1, i1 = fn()
    v2, i2 = fn()
    assert torch.equal(v1, v2) and torch.equal(i1, i2)
    return v1, i1


@pytest.mark.parametrize("kernel", ["topk", "coarse"])
@pytest.mark.parametrize("b", [1, 3, 8, 33, 128])
@pytest.mark.parametrize("m", [1, 20, 80, 128, 129, 200, N_RAGGED])
def test_selection_kernels_ragged_bit_identical(cuda, kernel, b, m):
    """Both kernels at ragged query tiles, across the threshold route (m <=
    128) and the rounds route (m > 128, m = n_items included): values and
    indices bit-identical to the plain versions, and across two runs."""
    q, items, excl = _ragged_case(cuda, b, 8, 64, b * 1000 + m)
    if kernel == "topk":
        kv, ki = _run_twice(lambda: tk.topk_cuda(q, items, excl, k=m))
        pv, pi = tk.topk_plain(q, items, excl, k=m)
    else:
        q8, qmeta = quantize_query(q)
        kv, ki = _run_twice(lambda: tk.coarse_topm_cuda(q8, qmeta, items,
                                                        excl, m=m))
        pv, pi = tk.coarse_topm_plain(q8, qmeta, items, excl, m=m)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    if m <= 200:                      # fewer than the non-excluded items
        assert not bool((ki[:, :, None] == excl[:, None, :]).any())


@pytest.mark.parametrize("kernel", ["topk", "coarse"])
@pytest.mark.parametrize("bits,dim", [(8, 64), (4, 64), (2, 64), (1, 64),
                                      (4, 37), (2, 37), (1, 37)])
def test_selection_kernels_bits_and_padded_packs(cuda, kernel, bits, dim):
    """Every bit width, and padded packs (d 37: dp not a multiple of 16, so
    the byte-by-byte staging), at an engine batch and the eval's k."""
    q, items, excl = _ragged_case(cuda, 8, bits, dim, bits * 100 + dim)
    if kernel == "topk":
        kv, ki = _run_twice(lambda: tk.topk_cuda(q, items, excl, k=20))
        pv, pi = tk.topk_plain(q, items, excl, k=20)
    else:
        q8, qmeta = quantize_query(q)
        kv, ki = _run_twice(lambda: tk.coarse_topm_cuda(q8, qmeta, items,
                                                        excl, m=80))
        pv, pi = tk.coarse_topm_plain(q8, qmeta, items, excl, m=80)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("kernel,bits,dim", [("topk", 8, 1000),
                                              ("topk", 0, 1000),
                                              ("coarse", 8, 300),
                                              ("coarse", 4, 600)])
def test_selection_kernels_wide_rows_stage_per_step(cuda, kernel, bits, dim):
    """Rows too wide to stage the query tile once a run (top-K past about
    850 features at tile 32) or a coarse tile once a step (K > 256): the
    query slice is staged with every step; bit-identical to the plain
    versions on integer-valued inputs (dense top-K: a dense fp32 table)."""
    q, items, excl = _ragged_case(cuda, 33, max(bits, 1), dim, dim + bits)
    if bits == 0:
        items = dequantize(items)
    if kernel == "topk":
        kv, ki = tk.topk_cuda(q, items, excl, k=20)
        pv, pi = tk.topk_plain(q, items, excl, k=20)
    else:
        q8, qmeta = quantize_query(q)
        kv, ki = tk.coarse_topm_cuda(q8, qmeta, items, excl, m=80)
        pv, pi = tk.coarse_topm_plain(q8, qmeta, items, excl, m=80)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("kernel", ["topk", "coarse"])
@pytest.mark.parametrize("m", [20, 80, 128])
def test_selection_kernels_all_scores_tied(cuda, kernel, m):
    """Zero queries: every score is 0, so only the ids order the result (the
    lowest non-excluded ids). The row merge's bound then keeps whole lists
    (3,001 items, 24 lists a row: over 1,024 survivors at m 80 and 128),
    which takes its merge rounds."""
    q, items, excl = _ragged_case(cuda, 8, 8, 64, m, N_COARSE)
    q = torch.zeros_like(q)
    if kernel == "topk":
        kv, ki = _run_twice(lambda: tk.topk_cuda(q, items, excl, k=m))
        pv, pi = tk.topk_plain(q, items, excl, k=m)
    else:
        q8, qmeta = quantize_query(q)
        kv, ki = _run_twice(lambda: tk.coarse_topm_cuda(q8, qmeta, items,
                                                        excl, m=m))
        pv, pi = tk.coarse_topm_plain(q8, qmeta, items, excl, m=m)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("b", [1, 8, 128])
def test_topk_kernel_random_values_close(cuda, b):
    """Random INT8 tables at the serving width: values within 1e-5 of the
    plain version (the sums run in other orders), indices equal except
    between near-ties, the returned values the dense scores of the returned
    ids and, bit for bit, their fp32 FMA chains in feature order; two runs
    bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(b)
    items = quantize(torch.randn((N_RAGGED, 256), generator=gen,
                                 device=cuda) * 0.3, 0, bits=8)
    q = torch.randn((b, 256), generator=gen, device=cuda) * 0.3
    excl = torch.randint(-1, N_RAGGED, (b, 12), generator=gen, device=cuda,
                         dtype=torch.int32)
    kv, ki = _run_twice(lambda: tk.topk_cuda(q, items, excl, k=20))
    pv, pi = tk.topk_plain(q, items, excl, k=20)
    scale = float(pv.abs().max())
    assert float((kv - pv).abs().max()) <= 1e-5 * scale
    assert bool(((kv - pv).abs()[ki != pi] <= 1e-5 * scale).all())
    dense = q @ dequantize(items).T
    assert float((torch.gather(dense, 1, ki.long()) - kv).abs().max()) \
        <= 1e-5 * scale
    # each value is the fp32 FMA chain over the features in order, from 0:
    # one rounding a step, emulated in float64 (the product is exact there,
    # and the sum is too while the terms' exponents differ by under 29)
    xhat = dequantize(items).double()
    chain = torch.zeros((b, N_RAGGED), dtype=torch.float32, device=cuda)
    for j in range(256):
        chain = (chain.double() + q[:, j:j + 1].double() * xhat[:, j]).float()
    assert torch.equal(torch.gather(chain, 1, ki.long()), kv)


def test_kernel_plans_launch_at_most_two_kernels(cuda):
    """The plan's launch count, counted by the C entry point at each launch
    (``backend.CUDA_KERNEL_COUNTS``) and read from the profiler: one scan
    and one merge at m <= 128, 1 + ceil(log2(tiles)) at m > 128. The
    profiled call sits 25 ms inside the profiler's capture window on both
    sides (``profiled_kernels``): the profiler drops a device event that
    its clock conversion places outside the window, and that conversion
    is off by up to a few milliseconds."""
    q, items, excl = _ragged_case(cuda, 8, 8, 64, 7)
    q8, qmeta = quantize_query(q)
    for m in (20, 128, 200):
        for run, coarse, name in (
                (lambda: tk.topk_cuda(q, items, excl, k=m), False,
                 "topk_score"),
                (lambda: tk.coarse_topm_cuda(q8, qmeta, items, excl, m=m),
                 True, "coarse_topm")):
            run()
            torch.cuda.synchronize()
            before = backend.CUDA_KERNEL_COUNTS[name]
            names = profiled_kernels(run)
            started = backend.CUDA_KERNEL_COUNTS[name] - before
            p = tk.plan_for(8, items, m, device=cuda, coarse=coarse)
            assert started == p.n_kernels, (started, p)
            assert len(names) == p.n_kernels, names
            assert m > 128 or p.n_kernels <= 2


TILES = (8, 16, 32)          # csrc/topk_select.cuh kQTiles


def _shape_table(cuda, n_items, dim=256):
    """A packed INT8 table: the plan reads only its shape."""
    return QTensor(torch.zeros((n_items, dim), dtype=torch.uint8,
                               device=cuda),
                   torch.ones((n_items, 1), device=cuda),
                   torch.zeros((n_items, 1), device=cuda), 8, dim)


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8, 9, 17, 33, 128])
def test_kernel_plan_query_tile(cuda, coarse, b):
    """The planner takes the smallest query tile >= B and B past the
    largest in tiles of it: from B 8 (the smallest tile, the coarse MMA's
    query block) on, at most half of a tile's rows are padding."""
    p = tk.plan_for(b, _shape_table(cuda, 12458), 80, device=cuda,
                    coarse=coarse)
    assert p.qt == next((t for t in TILES if t >= b), TILES[-1])
    if b >= TILES[0]:
        assert -(-b // p.qt) * p.qt <= 2 * b


@pytest.mark.parametrize("kernel", ["topk", "coarse"])
@pytest.mark.parametrize("b,m", [(1, 20), (8, 80), (33, 20), (33, 200)])
def test_selection_kernels_same_bits_at_every_query_tile(cuda, kernel, b,
                                                         m):
    """The query tile changes the schedule (units, runs, lists a row), not
    the result: values and indices bit-identical at every tile, on random
    inputs (top-K's values are each dot's FMA chain in feature order)."""
    gen = torch.Generator(device=cuda).manual_seed(b + m)
    items = quantize(torch.randn((N_RAGGED, 64), generator=gen,
                                 device=cuda), 0, bits=4)
    q = torch.randn((b, 64), generator=gen, device=cuda)
    excl = torch.randint(-1, N_RAGGED, (b, 12), generator=gen, device=cuda,
                         dtype=torch.int32)
    if kernel == "topk":
        runs = [tk._topk_cuda(q, items, excl, m, qt) for qt in TILES]
    else:
        q8, qmeta = quantize_query(q)
        runs = [tk._coarse_topm_cuda(q8, qmeta, items, excl, m, qt)
                for qt in TILES]
    for v, i in runs[1:]:
        assert torch.equal(v, runs[0][0]) and torch.equal(i, runs[0][1])


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("b,n_items,m", [(8, 24915, 20), (128, 24915, 20),
                                         (8, 12458, 80), (128, 24915, 80),
                                         (8, 100, 20), (1, 24915, 128),
                                         (8, 24915, 200), (8, 3001, 3001)])
def test_kernel_plan_route_and_scratch(cuda, coarse, b, n_items, m):
    """The route follows m alone: m <= 128 the threshold route (one scan,
    and one row merge where a row has more than one list: at most 2 CUDA
    launches), m > 128 merge rounds over one list of 128 per item tile.
    The scratch is B * slots * min(m, 128) entries of 8 bytes a buffer; a
    row's lists fit the row merge's shared memory (227 KB), the grid
    shrinking where they would not (B 1, m 128)."""
    p = tk.plan_for(b, _shape_table(cuda, n_items), m, device=cuda,
                    coarse=coarse)
    n_tiles = -(-n_items // 128)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 0 < p.grid <= min(-(-b // p.qt) * n_tiles, 2 * n_sm)
    if m > 128:
        assert (p.route, p.slots, p.list_len, p.n_buffers) == (
            "rounds", n_tiles, 128, 2)
        assert p.n_kernels == 1 + (n_tiles - 1).bit_length()
        assert p.scratch_bytes == b * n_tiles * 128 * 8
        return
    merge_bytes = (2 * p.slots * m + 1024) * 8 + (p.slots + 1) * 4
    assert (p.route, p.list_len) == ("threshold", m)
    assert merge_bytes <= 232448
    assert p.n_kernels == (2 if p.slots > 1 else 1)
    assert p.n_buffers == (1 if p.slots > 1 else 0)
    assert p.scratch_bytes == (b * p.slots * m * 8 if p.slots > 1 else 0)
    if b == 1:          # one query tile: a list per CTA, slots == grid
        assert p.slots == p.grid
        if p.grid < min(n_tiles, n_sm):        # capped by the row merge
            assert (2 * (p.slots + 1) * m + 1024) * 8 > 232448 - 64


def test_kernel_rejects_scratch_smaller_than_its_plan(cuda):
    """The launcher checks the scratch the caller passes against its own
    plan and refuses a buffer one entry short."""
    q, items, excl = _ragged_case(cuda, 8, 8, 64, 3)
    p = tk.plan_for(8, items, 20, device=cuda)
    assert p.n_buffers == 1
    buf = torch.empty(p.scratch_bytes, dtype=torch.uint8, device=cuda)
    v = torch.empty((8, 20), device=cuda)
    i = torch.empty((8, 20), dtype=torch.int32, device=cuda)
    fn = backend.kernel_fn("topk_score", "topk_launch", tk._ARGTYPES)
    args = [q.data_ptr(), 8, 64, items.packed.data_ptr(),
            items.packed.shape[1], 8, None, items.scale.data_ptr(),
            items.zero.data_ptr(), excl.data_ptr(), excl.shape[1],
            N_RAGGED, 20, 0, buf.data_ptr(), None]
    started = ctypes.c_int(0)
    tail = [v.data_ptr(), i.data_ptr(), backend.stream_of(q),
            ctypes.byref(started)]
    assert fn(*args, p.scratch_bytes - 8, *tail) != 0
    assert started.value == 0
    assert fn(*args, p.scratch_bytes, *tail) == 0
    assert started.value == p.n_kernels
    pv, pi = tk.topk_plain(q, items, excl, k=20)
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("dim", [64, 37, 256])
def test_dequant_unpack_kernel_bit_identical(cuda, bits, dim):
    """Every row, and the fused gather: unsorted and duplicate int32 and
    int64 indices, an empty index, and a packed table 1 byte off alignment
    (dp 10 at d 37 INT2: not a multiple of 4), all bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(bits + dim)
    q = quantize(torch.randn((1001, dim), generator=gen, device=cuda), 7,
                 bits=bits, stochastic=True)
    got = qp.dequant_unpack_cuda(q.packed, q.scale, q.zero, bits=bits,
                                 dim=dim)
    assert got.shape == (1001, dim)
    assert torch.equal(got, qp.dequant_unpack_plain(q.packed, q.scale,
                                                    q.zero, bits=bits,
                                                    dim=dim))
    assert torch.equal(got, dequantize(q))
    idx = torch.randint(0, 1001, (640,), generator=gen, device=cuda)
    idx[:7] = idx[7]
    shifted = _shifted(q.packed, 1)
    for dtype in (torch.int32, torch.int64):
        i = idx.to(dtype)
        rows = qp.dequant_unpack_cuda(q.packed, q.scale, q.zero, bits=bits,
                                      dim=dim, idx=i)
        assert torch.equal(rows, qp.dequant_unpack_plain(
            q.packed, q.scale, q.zero, bits=bits, dim=dim, idx=i))
        assert torch.equal(rows, got[idx])
        assert torch.equal(rows, ops.dequantize_rows(q, i))
        assert torch.equal(qp.dequant_unpack_cuda(
            shifted, q.scale, q.zero, bits=bits, dim=dim, idx=i), rows)
    empty = qp.dequant_unpack_cuda(q.packed, q.scale, q.zero, bits=bits,
                                   dim=dim, idx=idx[:0])
    assert empty.shape == (0, dim)


_BAD_INDEX = """
import sys, torch
from repro_torch.core.quant import quantize
from repro_torch.kernels import ops
q = quantize(torch.randn((50, 64), device="cuda"), bits=4)
ops.dequantize_rows(q, torch.tensor([0, int(sys.argv[1])], device="cuda"))
torch.cuda.synchronize()
"""


def test_dequant_unpack_indexes_as_torch(cuda):
    """Negative indices count from the end, as in the plain version's
    ``packed[idx]``; an index outside [-rows, rows) stops the kernel with a
    device-side assert, as torch's own indexing does on the card (in a child
    process: the assert ends its CUDA context)."""
    import os
    import subprocess
    import sys

    gen = torch.Generator(device=cuda).manual_seed(5)
    q = quantize(torch.randn((50, 64), generator=gen, device=cuda), 3,
                 bits=4)
    for dtype in (torch.int32, torch.int64):
        idx = torch.tensor([-1, -50, 0, 49], dtype=dtype, device=cuda)
        assert torch.equal(ops.dequantize_rows(q, idx),
                           dequantize(q)[[49, 0, 0, 49]])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    for bad in (50, -51):
        r = subprocess.run([sys.executable, "-c", _BAD_INDEX, str(bad)],
                           capture_output=True, text=True, env=env,
                           timeout=300)
        assert r.returncode != 0
        # torch's report at the synchronize, or the launcher's (710 is
        # cudaErrorAssert) where the kernel has already stopped
        assert ("device-side assert" in r.stderr
                or "CUDA error 710" in r.stderr), r.stderr[-2000:]


def test_reduced_tier2_serving_path_runs_the_kernels(cuda):
    """The tier-2 launcher path on the card (two-stage, 2 shards, cache,
    training and a delta refresh) launches the coarse and dequant kernels
    and serves from the refreshed store."""
    cfg = reduced(get("kgat")).model_cfg
    ds = reduced_dataset(cfg)
    backend.reset_counts()
    res = serve_kgnn(cfg, ds, kgnn.init_params(cfg, device=cuda), bits=8,
                     k=10, requests=24, device=cuda, train_steps=2,
                     two_stage=4, item_shards=2, cache=16, refresh_steps=2,
                     log=lambda _: None)
    counts = dict(backend.LAUNCH_COUNTS)
    want = SERVING + ("coarse_topm", "dequant_unpack", "sddmm",
                      "segment_sum")
    assert all(counts.get(n, 0) > 0 for n in want), counts
    assert res["delta"]["version"] == 1
    assert res["stats_post"].store_version == 1
    for a, b in ((res["live_store"].items, res["new_store"].items),
                 (res["live_store"].users, res["new_store"].users)):
        assert torch.equal(a.packed, b.packed)
    assert res["dense_delta"] <= 1e-6


def test_two_stage_leaves_tf32_setting_alone(cuda):
    """The re-rank is full fp32 whatever the caller's TF32 setting, and it
    does not change that setting."""
    q8, _, items, excl = _coarse_case(cuda, "random", 8, 256)
    q = q8 * 0.01
    before = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            out[flag] = two_stage_topk(q, items, 20, c=4, exclude=excl)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])


class _GradRecorder:
    """An optimizer that keeps the step's gradients and moves nothing."""

    def update(self, grads, state, params):
        self.grads = grads
        return params, state


def test_rollout_and_training_step_leave_tf32_setting_alone(cuda):
    """A rollout (``forward_reps``) and a training step (forward and
    backward) run in full fp32 whatever the caller's TF32 setting, and leave
    that setting as they found it."""
    cfg = reduced(get("kgat")).model_cfg
    ds = reduced_dataset(cfg)
    step = build_step(cfg.model, ds=ds, cfg=cfg, batch_size=32, device=cuda)
    g = step.data["graph"]
    batch = next(step.batches())
    params = kgnn.init_params(cfg, device=cuda)
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    reps, loss, grads = {}, {}, {}
    try:
        for flag in (False, True):
            flags.allow_tf32 = flag
            reps[flag] = kgnn.propagate(params, g, cfg)
            assert flags.allow_tf32 is flag
            opt = _GradRecorder()
            train_step = make_train_step(step, opt,
                                         schedule=schedule_from_cli(None, 2),
                                         root_seed=1)
            _, metrics = train_step((trainable(params), None), batch, 0)
            assert flags.allow_tf32 is flag
            loss[flag], grads[flag] = metrics["loss"], opt.grads
    finally:
        flags.allow_tf32 = before
    assert torch.equal(reps[True], reps[False])
    assert torch.equal(loss[True], loss[False])
    for a, b in zip(grads[True], grads[False]):     # the step is deterministic
        assert torch.equal(a, b)


def test_sharded_engine_on_streams_matches_one_shard(cuda):
    """Two item shards on their own streams of one card serve the bits one
    shard serves, and each shard's stage times are recorded per batch."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    users = torch.randint(-2, 3, (24, 64), generator=gen,
                          device=cuda).to(torch.float32)
    items = torch.randint(0, 4, (N_COARSE, 64), generator=gen,
                          device=cuda).to(torch.float32)
    items[:, 0], items[:, 1] = 0.0, 3.0        # exact INT8 rows
    st = QuantizedEmbeddingStore.from_arrays(users, items, bits=8)
    res = {}
    for shards in (1, 2):
        with ServingEngine(st, k=20, buckets=(8,), item_shards=shards,
                           two_stage_c=4) as eng:
            res[shards] = eng.score_batch(np.arange(24))
            stage = eng._m_stage["coarse"]
            assert stage.snapshot()["count"] == 3 * shards
    np.testing.assert_array_equal(res[1][1], res[2][1])
    np.testing.assert_array_equal(res[1][0], res[2][0])


def _sampled_world(dev, model, fanouts=(3, 2)):
    from repro_torch.data.synthetic import gen_zipf_kg_dataset

    ds = gen_zipf_kg_dataset(n_users=60, n_items=100, n_attrs=40,
                             n_triples=600, seed=0)
    cfg = kgnn.KGNNConfig(
        model=model, n_users=ds.n_users, n_entities=ds.n_entities,
        n_relations=ds.n_relations, dim=16, n_layers=len(fanouts),
        readout="concat" if model == "kgat" else "sum")
    return ds, build_step(arch_of(model), ds=ds, cfg=cfg, device=dev,
                          device_graph=False)


def test_sampled_blocks_run_the_kernels_like_the_plain_versions(cuda):
    """On a sampled block (n_src several times n_dst, trailing all-pad
    blocks in both directions, masked slots with real endpoints) each
    kernel computes what its plain version computes, and the same bits
    twice."""
    from repro_torch.data.minibatch import sampled_items

    ds, _ = _sampled_world("cpu", "kgat")
    item = next(sampled_items(ds, (5, 4), batch_size=64, seed=0))
    gen = torch.Generator(device=cuda).manual_seed(0)
    for blk in item.view.blocks:
        m = blk.layout.meta
        assert m.n_src > m.n_dst and (blk.mask == 0).any()
        assert m.n_blocks * m.block_e > m.n_edges
        cb = blk.to(cuda)
        x = torch.randn((m.n_src, 64), generator=gen, device=cuda)
        g = torch.randn((m.n_dst, 64), generator=gen, device=cuda)
        ew = torch.rand((m.n_edges,), generator=gen, device=cuda) * cb.mask
        q = quantize(x, 3, bits=2)
        cases = [
            (lambda: ops.spmm(x, ew, cb.layout),
             lambda: sp.spmm_plain(x, ew, cb.layout)),
            (lambda: ops.spmm(g, ew, cb.layout, transpose=True),
             lambda: sp.spmm_plain(g, ew, cb.layout, transpose=True)),
            (lambda: ops.spmm(x[:, :1].contiguous(), ew, cb.layout),
             lambda: sp.spmm_plain(x[:, :1], ew, cb.layout)),
            (lambda: ops.spmm_grad_ew(x, g, cb.layout),
             lambda: sp.sddmm_plain(x, g, cb.layout)),
            (lambda: ops.spmm_grad_ew(q, g, cb.layout),
             lambda: sp.dequant_sddmm_plain(q, g, cb.layout)),
            (lambda: ops.segment_sum(x[:m.n_edges], cb.rel_runs),
             lambda: sp.segment_sum_plain(x[:m.n_edges], cb.rel_runs)),
            (lambda: ops.segment_sum(cb.mask, cb.layout.runs()),
             lambda: sp.segment_sum_plain(cb.mask, cb.layout.runs())),
        ]
        for kernel, plain in cases:
            a, ref = kernel(), plain()
            assert _rel(a, ref) <= 1e-5
            assert torch.equal(kernel(), a)


@pytest.mark.parametrize("model", ["kgat", "kgcn", "kgin", "rgcn"])
def test_sampled_training_on_card_follows_cpu_and_repeats(cuda, model):
    """Three sampled INT2 steps on the card follow the CPU's plain versions
    and launch the path's kernels; two runs, and the overlapped and
    sequential schedules, give the same bits (losses, dense parameters,
    the flushed entity table); no step launches index_add_."""
    from repro_torch.training.tiering import run_sampled_training

    sched = schedule_from_cli(None, 2)
    kw = dict(fanouts=(3, 2), steps=3, batch_size=16, hot_frac=0.2,
              refresh_every=2, schedule=sched, root_seed=1)
    _, cpu_step = _sampled_world("cpu", model)
    ref, _, _ = run_sampled_training(cpu_step, **kw)
    _, step = _sampled_world(cuda, model)
    runs = []
    for overlap in (True, True, False):
        backend.reset_counts()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            runs.append(run_sampled_training(step, overlap=overlap, **kw))
        assert not [e.key for e in prof.key_averages()
                    if "indexFunc" in e.key]
        assert all(backend.LAUNCH_COUNTS.get(k, 0) > 0
                   for k in path_kernels(model, packed=True))
    np.testing.assert_allclose(runs[0][0].losses, ref.losses, rtol=1e-4)
    (r1, d1, s1) = runs[0]
    for r2, d2, s2 in runs[1:]:
        assert r1.losses == r2.losses
        assert np.array_equal(s1.flush(), s2.flush())
        for a, b in zip(param_leaves(d1), param_leaves(d2)):
            assert torch.equal(a, b)
    assert r1.peak_device_bytes > 0 and r1.stats["patch_rows"] > 0


@pytest.mark.parametrize("arch", ["kgat", "kgin"])
def test_two_rank_step_on_card_follows_single_device(cuda, arch):
    """Two gloo ranks sharing the card (``data=2``), kernels on: the FP32
    forward rows equal the single-device kernel rollout's within 1e-6
    relative, the exact all-reduce step's loss within 1e-6 and gradients
    within 1e-5 of max |grad| of the single-device kernel step; two INT2
    steps with the int8 all-reduce keep the ranks' copies equal (the step
    checks) and give both ranks the same finite losses; every kernel of
    the path launched on each rank."""
    from _torch_dp_ranks import card_job, dataset, step_of

    from repro_torch.core.context import act_context
    from repro_torch.launch.mesh import run_ranks

    res = run_ranks(card_job, "data=2", device="cuda", args=(arch,),
                    timeout_s=300)
    step = step_of(arch, dataset(), device=cuda)
    params = step.init(0)
    reps = kgnn.propagate(params, step.data["graph"], step.cfg).cpu().numpy()
    with act_context(None, 7) as ctx:
        loss = step.loss(params, next(iter(step.batches())), ctx=ctx)
    grads = [g.cpu().numpy() for g in
             torch.autograd.grad(loss, param_leaves(params))]
    gmax = max(np.abs(g).max() for g in grads)
    for r in res:
        assert np.abs(r["reps"] - reps).max() <= 1e-6 * np.abs(reps).max()
        assert abs(r["loss"] - float(loss)) <= 1e-6
        assert max(np.abs(a - b).max() for a, b in
                   zip(r["grads"], grads)) <= 1e-5 * gmax
        assert r["losses"] == res[0]["losses"]
        assert np.isfinite(r["losses"]).all()
        for k in path_kernels(arch, True):
            assert r["counts"].get(k, 0) > 0, k


# -- the GCN (gcn-cora) shapes ------------------------------------------------


def _cora_layout(cuda):
    """The ``full_graph_sm`` graph's edges (2,708 nodes, self loops)."""
    from repro_torch.data.synthetic import cora_like

    _, src, dst, _ = cora_like(n_nodes=2708, d_feat=1, avg_deg=3)
    return build_spmm_layout(src, dst, n_dst=2708, device=cuda)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("d", [7, 16])
def test_spmm_kernel_gcn_widths(cuda, transpose, d):
    """The GCN's unweighted aggregation at its widths (d 16 and 7, lanes 4
    with float4 columns and 8 scalar ones), both directions."""
    layout = _cora_layout(cuda)
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((2708, d), generator=gen, device=cuda)
    a = sp.spmm_cuda(x, None, layout, transpose=transpose)
    assert torch.equal(a, sp.spmm_cuda(x, None, layout, transpose=transpose))
    assert _rel(a, sp.spmm_plain(x, None, layout, transpose=transpose)) \
        <= 1e-5


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("rows,d", [(2708, 1433), (4099, 100)])
def test_quant_pack_kernel_gcn_widths(cuda, bits, stochastic, rows, d):
    """The GCN's input residuals: Cora's 1,433 features (dp 359 at INT2,
    an odd row stride) and ogbn-products' 100 (dp 25), codes bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(rows + bits)
    x = torch.randn((rows, d), generator=gen, device=cuda)
    got = qp.quant_pack_cuda(x, 7, bits=bits, stochastic=stochastic)
    ref = qp.quant_pack_plain(x, 7, bits=bits, stochastic=stochastic)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("rows,dim,n", [(2708, 1433, 16), (2708, 16, 7),
                                        (70000, 100, 47)])
def test_dequant_matmul_kernel_gcn_shapes(cuda, bits, rows, dim, n):
    """∇W of the GCN's layers: 23 feature tiles (the last 25 wide) at dim
    1,433, 4-byte g copies at n 7 and 47, a 25-byte pack at dim 100."""
    gen = torch.Generator(device=cuda).manual_seed(dim + n)
    x = torch.randn((rows, dim), generator=gen, device=cuda)
    g = torch.randn((rows, n), generator=gen, device=cuda)
    q = quantize(x, 5, bits=bits, stochastic=True)
    a = dq.dequant_matmul_cuda(q, g)
    assert torch.equal(a, dq.dequant_matmul_cuda(q, g))
    assert _rel(a, dq.dequant_matmul_plain(q, g)) <= 1e-5


@pytest.mark.parametrize("bits", [0, 2])
def test_reduced_gcn_step_launches_its_kernels_and_repeats(cuda, bits):
    """A reduced gcn-cora step (the CPU step's config and graph) on the
    card launches exactly ``path_kernels("gcn", ...)``, follows the CPU's
    plain versions over 3 steps, and two steps from one state give the
    same bits."""
    from repro_torch.launch.train import train_model
    from repro_torch.models.registry import GNN_CPU_NODES
    from repro_torch.data.synthetic import cora_like

    cfg = reduced(get("gcn-cora")).model_cfg
    data = cora_like(n_nodes=GNN_CPU_NODES, d_feat=cfg.d_in)
    sched = schedule_from_cli(None, bits)
    runs = {}
    for dev in ("cpu", cuda):
        step = build_step("gcn-cora", device=dev, cfg=cfg, data=data)
        runs[str(dev)] = train_model(step, step.init(0), sched, 3,
                                     log=lambda _: None)
    launches = runs[str(cuda)]["steps"][0]["launches"]
    assert set(launches) == set(path_kernels("gcn", bool(bits))), launches
    losses = [[r["loss"] for r in run["steps"]] for run in runs.values()]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)

    opt = adam(step.lr)
    params = step.init(0)
    train = make_train_step(step, opt, schedule=sched, root_seed=1)
    state, _ = train((params, opt.init(params)), {}, 0)
    (p1, o1), m1 = train(_clone_state(state), {}, 1)
    (p2, o2), m2 = train(_clone_state(state), {}, 1)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(param_leaves(p1) + o1["mu"] + o1["nu"],
                    param_leaves(p2) + o2["mu"] + o2["nu"]):
        assert torch.equal(a, b)


# -- the recsys family's shapes ------------------------------------------------


@pytest.mark.parametrize("rows,d,bits,stochastic", [
    (40960, 7800, 2, True),      # xDeepFM's CIN layers 1-2 at batch 4,096
    (4096, 13, 2, True),         # DLRM's dense input (4-byte packed rows)
])
def test_quant_pack_kernel_recsys_shapes(cuda, rows, d, bits, stochastic):
    """Codes, scale and zero bit-identical to the plain version, and two
    calls bit-identical, at the recsys ACT sites' widths."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((rows, d), generator=gen, device=cuda)
    got = qp.quant_pack_cuda(x, 17, bits=bits, stochastic=stochastic)
    again = qp.quant_pack_cuda(x, 17, bits=bits, stochastic=stochastic)
    ref = qp.quant_pack_plain(x, 17, bits=bits, stochastic=stochastic)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, r)
        assert torch.equal(g, a)


@pytest.mark.parametrize("rows,dim,n", [
    (40960, 7800, 200),          # xDeepFM's CIN ∇W: 488 output tiles
    (4096, 256, 1),              # an MLP's last layer: n 1, no 16-byte g
    (4096, 13, 512),             # DLRM's bottom fc0: 4-byte packed rows
])
def test_dequant_matmul_kernel_recsys_shapes(cuda, rows, dim, n):
    """Within 1e-5 relative of the plain version and bit-identical twice,
    INT2 (the recsys training schedule's width)."""
    x, g = _dqmm_table(cuda, "cancel", rows, dim, n, dim + n)
    q = quantize(x, 5, bits=2, stochastic=True)
    a = dq.dequant_matmul_cuda(q, g)
    assert a.shape == (dim, n)
    assert torch.equal(a, dq.dequant_matmul_cuda(q, g))
    assert _rel(a, dq.dequant_matmul_plain(q, g)) <= 1e-5


@pytest.mark.parametrize("d", [11, 33, 129])
def test_topk_kernel_recsys_tower_widths(cuda, d):
    """Top-32 over an INT8 item tower of width d (xDeepFM and FM's k + 1,
    Wide&Deep's, DLRM's), 100,003 items, B 8: values within 1e-5 of the
    plain version, indices equal except between near-ties, the values the
    dense scores of the returned ids; integer-valued ties bit-identical;
    two runs bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    n_items, b, k = 100003, 8, 32
    items = quantize(torch.randn((n_items, d), generator=gen, device=cuda),
                     0, bits=8)
    q = torch.randn((b, d), generator=gen, device=cuda)
    excl = torch.full((b, 1), -1, dtype=torch.int32, device=cuda)
    kv, ki = _run_twice(lambda: tk.topk_cuda(q, items, excl, k=k))
    pv, pi = tk.topk_plain(q, items, excl, k=k)
    scale = float(pv.abs().max())
    assert float((kv - pv).abs().max()) <= 1e-5 * scale
    assert bool(((kv - pv).abs()[ki != pi] <= 1e-5 * scale).all())
    dense = q @ dequantize(items).T
    assert float((torch.gather(dense, 1, ki.long()) - kv).abs().max()) \
        <= 1e-5 * scale
    codes = torch.randint(0, 4, (n_items, d), generator=gen,
                          device=cuda).to(torch.uint8)
    ties = QTensor(pack_bits(codes, 8), torch.ones((n_items, 1), device=cuda),
                   torch.zeros((n_items, 1), device=cuda), 8, d)
    qi = torch.randint(-2, 3, (b, d), generator=gen,
                       device=cuda).to(torch.float32)
    kv, ki = _run_twice(lambda: tk.topk_cuda(qi, ties, excl, k=k))
    pv, pi = tk.topk_plain(qi, ties, excl, k=k)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


def reduced_recsys_losses(arch, device, *, steps: int = 3,
                          batch: int = 256):
    """The losses of ``steps`` reduced INT2 steps of ``arch`` (registry
    step, ``batch`` examples), on the CPU and on ``device`` from the same
    seed-0 parameters, by device name; and the step and run on ``device``.
    ``chip_smoke.py``'s [recsys] phase holds the card to the CPU with it
    too."""
    from repro_torch.launch.train import train_model
    from repro_torch.models import recsys

    cfg = reduced(get(arch)).model_cfg
    params = recsys.init_params(cfg, seed=0, device="cpu")
    losses = {}
    for dev in ("cpu", device):
        step = build_step(arch, device=dev, cfg=cfg, batch_size=batch)
        run = train_model(step, {k: [t.to(dev) for t in v]
                                 if isinstance(v, list) else v.to(dev)
                                 for k, v in params.items()},
                          schedule_from_cli(None, 2), steps,
                          log=lambda _: None)
        losses[str(dev)] = [r["loss"] for r in run["steps"]]
    return losses, step, run


@pytest.mark.parametrize("arch", ["fm", "wide-deep", "dlrm-mlperf",
                                  "xdeepfm"])
def test_reduced_recsys_training_on_card(cuda, arch):
    """Three reduced INT2 steps on the card follow the CPU's plain versions
    (losses within 1e-4) from the same parameters, launch exactly the
    path's kernels, and two steps from one state are bit-identical."""
    losses, step, run = reduced_recsys_losses(arch, cuda)
    sched = schedule_from_cli(None, 2)
    assert set(run["steps"][-1]["launches"]) == set(
        path_kernels(step.cfg.model, True))
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-4)
    opt = adam(step.lr)
    train = make_train_step(step, opt, schedule=sched, root_seed=1)
    batch = next(step.batches())
    p = trainable(run["params"])
    state = (p, opt.init(p))
    outs = []
    for _ in range(2):
        s = ({k: [t.detach().clone().requires_grad_() for t in v]
              if isinstance(v, list) else v.detach().clone().requires_grad_()
              for k, v in state[0].items()},
             {"step": 0, "mu": [m.clone() for m in state[1]["mu"]],
              "nu": [v.clone() for v in state[1]["nu"]]})
        (p2, o2), m = train(s, batch, 0)
        outs.append([m["loss"]] + param_leaves(p2) + o2["mu"] + o2["nu"])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("d", [10, 1])
def test_recsys_table_gradient_on_card(cuda, d):
    """The lookups' backward on the card (``gather_rows`` with ``rows=``):
    a reduced xDeepFM batch of 1,024, whose hub rows hold more than a
    chunk's slots (the segment sum's two-kernel route), against
    ``index_add_`` in float64 within 1e-5 of its max, rows no id reaches
    zero, two runs bit-identical; the embedding width and the linear
    term's."""
    from repro_torch.core.act import gather_rows
    from repro_torch.data.synthetic import criteo_batches
    from repro_torch.models import recsys

    cfg = reduced(get("xdeepfm")).model_cfg
    b = next(criteo_batches(batch=1024, n_dense=1,
                            vocab_sizes=cfg.vocab_sizes, seed=3))
    plan = recsys.lookup_plan(b["sparse"], cfg, cuda)
    lv = plan.runs[0]
    assert int((lv.row_end - lv.row_start).max()) > SEG_CHUNK
    table = torch.zeros((cfg.total_vocab, d), device=cuda,
                        requires_grad=True)
    gen = torch.Generator(device=cuda).manual_seed(d)
    g = torch.randn((plan.ids.numel(), d), generator=gen, device=cuda)
    before = backend.CUDA_KERNEL_COUNTS["segment_sum"]
    got, again = (torch.autograd.grad(
        gather_rows(table, plan.ids, plan.runs, rows=plan.rows), table, g)[0]
        for _ in range(2))
    assert backend.CUDA_KERNEL_COUNTS["segment_sum"] - before == 4
    assert torch.equal(got, again)
    ref = torch.zeros((cfg.total_vocab, d), dtype=torch.float64,
                      device=cuda).index_add_(0, plan.ids, g.double())
    assert float((got.double() - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max())



# -- the LM families (slice 6c) ----------------------------------------------

LM_ARCHS = ("mistral-large-123b", "codeqwen1.5-7b", "stablelm-12b",
            "moonshot-v1-16b-a3b", "grok-1-314b")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,stochastic", [(2, True), (8, False),
                                             (4, True)])
@pytest.mark.parametrize("rows,d,where", [
    (1031, 5120, "full"), (1031, 2048, "full"), (257, 5120, "slice"),
    (3001, 37, "full"), (3001, 37, "slice"), (5, 40000, "full")])
def test_quant_pack_kernel_lm_widths(cuda, dtype, bits, stochastic, rows, d,
                                     where):
    """fp32 and bf16 rows at the LM block inputs' widths (stablelm's 5,120,
    moonshot's 2,048), at an odd width on both routes and on a misaligned
    base (``x[1:]``: 2 bytes off a 16-byte boundary in bf16), and a row
    wider than the ring: codes, scale and zero bit-identical to the plain
    version on the fp32 upcast, twice the same."""
    gen = torch.Generator(device=cuda).manual_seed(d + bits)
    x = torch.randn((rows + (where == "slice"), d), generator=gen,
                    device=cuda).to(dtype)
    if where == "slice":
        x = x[1:]
        assert x.is_contiguous()
    x[min(3, rows - 1)] = 0.25                             # R == 0
    got = qp.quant_pack_cuda(x, 0x5EED, bits=bits, stochastic=stochastic)
    again = qp.quant_pack_cuda(x, 0x5EED, bits=bits, stochastic=stochastic)
    ref = qp.quant_pack_plain(x.float(), 0x5EED, bits=bits,
                              stochastic=stochastic)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, r)
        assert torch.equal(g, a)
    plan = qp.quant_pack_plan(rows, d, bits=bits, stochastic=stochastic,
                              dtype=dtype)
    assert plan["route"] in ("tiles", "rows")


def test_quantize_takes_bf16_without_a_copy(cuda):
    """``ops.quantize`` hands a bf16 table to the kernel as it is: the
    QTensor restores bf16 and its codes are the fp32 upcast's."""
    x = torch.randn((4096, 2048), device=cuda).to(torch.bfloat16)
    q = ops.quantize(x, 7, bits=2, stochastic=True)
    ref = qp.quant_pack_plain(x.float(), 7, bits=2, stochastic=True)
    assert q.dtype == torch.bfloat16
    for g, r in zip((q.packed, q.scale, q.zero), ref):
        assert torch.equal(g, r)


def reduced_lm_losses(arch, device, *, bits: int = 2, steps: int = 3):
    """The losses of ``steps`` reduced steps of LM ``arch`` at ``bits``
    (registry step: batch 8, seq 64) on the CPU and on ``device`` from the
    same seed-0 parameters, by device name; and the step and run on
    ``device``. ``chip_smoke.py``'s [lm] phase holds the card to the CPU
    with it too."""
    from repro_torch.launch.train import train_model
    from repro_torch.models import transformer as tf

    cfg = reduced(get(arch)).model_cfg
    params = tf.init_params(cfg, seed=0, device="cpu")
    losses = {}
    for dev in ("cpu", device):
        step = build_step(arch, device=dev, cfg=cfg, batch_size=8, seq=64)
        run = train_model(step, {k: [t.to(dev) for t in v]
                                 if isinstance(v, list) else v.to(dev)
                                 for k, v in params.items()},
                          schedule_from_cli(None, bits), steps,
                          log=lambda _: None)
        losses[str(dev)] = [r["loss"] for r in run["steps"]]
    return losses, step, run


@pytest.mark.parametrize("bits", [0, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reduced_lm_training_on_card(cuda, arch, bits):
    """Three reduced steps on the card follow the CPU's plain versions
    (losses within 1e-5) from the same parameters and launch exactly the
    path's kernels every step."""
    losses, step, run = reduced_lm_losses(arch, cuda, bits=bits)
    want = set(path_kernels(step.cfg.model, bits != 0))
    assert all(set(r["launches"]) == want for r in run["steps"])
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-5)


def teacher_forced_logits(cfg, params, prompt, feed):
    """``transformer.prefill`` of ``prompt`` (B, P) into a cache of ``P +
    feed.shape[1]`` positions, then a ``decode_step`` for each column of
    ``feed`` (B, n), fed in place of the argmax (teacher forcing): the
    prefill's logits and each step's, on ``prompt``'s device.
    ``chip_smoke.py``'s [lm-serve] compares the int8 and bf16 caches with
    it too."""
    from repro_torch.models import transformer as tf

    B, P = prompt.shape
    cache = tf.init_cache(cfg, B, P + feed.shape[1], prompt.device)
    with torch.no_grad():
        logits, cache = tf.prefill(params, prompt, cfg, cache)
        out = [logits]
        for i in range(feed.shape[1]):
            logits, cache = tf.decode_step(params, cache, feed[:, i:i + 1],
                                           cfg)
            out.append(logits)
    return out


def test_lm_serving_on_card_follows_cpu(cuda):
    """Prefill and 4 teacher-forced decode steps of reduced stablelm with
    the int8 cache on the card against the CPU (logits within 1e-5
    relative)."""
    import dataclasses

    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(reduced(get("stablelm-12b")).model_cfg,
                              kv_cache_bits=8)
    params = tf.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 4)))
    cpu = teacher_forced_logits(cfg, params, prompt, feed)
    card = teacher_forced_logits(
        cfg, {k: [t.to(cuda) for t in v] if isinstance(v, list)
              else v.to(cuda) for k, v in params.items()},
        prompt.to(cuda), feed.to(cuda))
    for a, b in zip(card, cpu):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-5 * float(b.abs().max())


@pytest.mark.parametrize("coarse", [False, True])
def test_autotuned_tile_same_bits_and_cached(cuda, coarse, tmp_path):
    """A sweep over the query tiles: every candidate's values and indices
    the default's bit for bit, the winner the one the cache then returns
    to a second tuner with no sweep, and the wrapper's call at the cached
    tile the default's bits too."""
    q, items, excl = _ragged_case(cuda, 8, 8, 64, 11, n_items=N_COARSE)
    q8, qmeta = quantize_query(q)
    op, m = ("coarse_topm", 80) if coarse else ("topk_score", 20)

    def run(qt):
        if coarse:
            return tk._coarse_topm_cuda(q8, qmeta, items, excl, m, qt)
        return tk._topk_cuda(q, items, excl, m, qt)

    want = run(0)
    for t in autotune.QUERY_TILES:
        got = run(t)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    path = str(tmp_path / "swept.json")
    pick = dict(shapes=(8, N_COARSE, 64), bits=8, extra=f"k{m}",
                candidates=[{"qt": t} for t in autotune.QUERY_TILES],
                measure=lambda p: run(p["qt"]), default={"qt": 0})
    first = autotune.Autotuner(path, sweep=True)
    winner = first.pick(op, **pick)
    assert first.n_sweeps == 3 and winner["qt"] in autotune.QUERY_TILES
    second = autotune.reset(path, sweep=True)
    assert second.pick(op, **pick) == winner and second.n_sweeps == 0
    got = (tk.coarse_topm_cuda(q8, qmeta, items, excl, m=m) if coarse
           else tk.topk_cuda(q, items, excl, k=m))
    assert second.n_sweeps == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_on_card_follows_cpu(cuda, combiner):
    """Weighted bags on the card against the CPU's plain run, forward and
    the table's gradient within 1e-6; the bag sums and the table gradient
    go through the segment-sum kernel, twice bit-identical."""
    from repro_torch.models.layers import embedding_bag

    rng = np.random.default_rng(5)
    idx = rng.integers(0, 300, 900)
    seg = np.sort(rng.integers(0, 64, 900))
    table = rng.standard_normal((300, 16)).astype(np.float32)
    w = rng.random(900).astype(np.float32)
    cot = rng.standard_normal((64, 16)).astype(np.float32)

    def run(dev):
        t = torch.tensor(table, device=dev, requires_grad=True)
        out = embedding_bag(t, idx, seg, 64, combiner=combiner,
                            weights=torch.tensor(w, device=dev))
        (out * torch.tensor(cot, device=dev)).sum().backward()
        return out.detach().cpu(), t.grad.cpu()

    before = backend.LAUNCH_COUNTS["segment_sum"]
    out, grad = run(cuda)
    assert backend.LAUNCH_COUNTS["segment_sum"] - before == 2
    again = run(cuda)
    assert torch.equal(out, again[0]) and torch.equal(grad, again[1])
    ref = run("cpu")
    assert float((out - ref[0]).abs().max()) <= 1e-6
    assert float((grad - ref[1]).abs().max()) <= 1e-6

