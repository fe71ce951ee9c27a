"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs an NVIDIA Hopper GPU and nvcc, and skips
without them (the kernels have no CPU or interpret mode). Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Small shapes; ``chip_smoke.py`` repeats the checks at the serving and
training paths' full-width shapes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.configs.smoke import reduced
from repro_torch.core.quant import QTensor, dequantize, pack_bits, quantize
from repro_torch.data.csr import build_spmm_layout
from repro_torch.core.policy import schedule_from_cli
from repro_torch.kernels import backend
from repro_torch.kernels import dequant_matmul as dq
from repro_torch.kernels import quant_pack as qp
from repro_torch.kernels import spmm as sp
from repro_torch.kernels import topk_score as tk
from repro_torch.launch.serve import reduced_dataset, serve_kgnn
from repro_torch.launch.train import train_kgnn
from repro_torch.models import kgnn
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scorer import quantize_query, two_stage_topk
from repro_torch.serving.store import QuantizedEmbeddingStore

SERVING = ("quant_pack", "spmm", "topk_score")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU and nvcc: the CUDA kernels "
                    "have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("d", [64, 37])
def test_quant_pack_kernel_bit_identical(cuda, bits, stochastic, d):
    gen = torch.Generator(device=cuda).manual_seed(bits * 7 + d)
    x = torch.randn((301, d), generator=gen, device=cuda)
    x[5] = 0.5                                            # R == 0
    got = qp.quant_pack_cuda(x, 99, bits=bits, stochastic=stochastic)
    ref = qp.quant_pack_plain(x, 99, bits=bits, stochastic=stochastic)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _layout(cuda, n_src, n_dst, n_edges, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, n_edges)
    dst = np.minimum(rng.zipf(1.5, n_edges) - 1, 2 * n_dst // 3)
    return build_spmm_layout(src, dst, n_dst=n_dst, n_src=n_src, block_e=32,
                             block_rows=16, device=cuda)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("d", [64, 200])
def test_spmm_kernel_close_and_deterministic(cuda, transpose, weighted, d):
    layout = _layout(cuda, 500, 700, 6000, d)
    m = layout.meta
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


@pytest.mark.parametrize("d", [1, 37, 64, 200])
def test_sddmm_kernel_close_and_deterministic(cuda, d):
    layout = _layout(cuda, 500, 700, 6000, d)         # pad slots, empty tiles
    m = layout.meta
    assert bool((layout.perm_blk == m.n_edges).any())
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((m.n_src, d), generator=gen, device=cuda)
    g = torch.randn((m.n_dst, d), generator=gen, device=cuda)
    a = sp.sddmm_cuda(x, g, layout)
    assert torch.equal(a, sp.sddmm_cuda(x, g, layout))
    assert _rel(a, sp.sddmm_plain(x, g, layout)) <= 1e-5


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("dim", [64, 37])
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


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("rows,dim,n", [(4099, 64, 64), (1000, 37, 24),
                                        (70000, 130, 70)])
def test_dequant_matmul_kernel_close_and_deterministic(cuda, bits, rows,
                                                       dim, n):
    gen = torch.Generator(device=cuda).manual_seed(rows + bits)
    q = quantize(torch.randn((rows, dim), generator=gen, device=cuda), 3,
                 bits=bits, stochastic=True)
    g = torch.randn((rows, n), generator=gen, device=cuda)
    a = dq.dequant_matmul_cuda(q, g)
    assert a.shape == (dim, n)
    assert torch.equal(a, dq.dequant_matmul_cuda(q, g))
    assert _rel(a, dq.dequant_matmul_plain(q, g)) <= 1e-5


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
    want = ("spmm", "sddmm") + (("quant_pack", "dequant_sddmm",
                                 "dequant_matmul") if bits else ())
    launches = runs[str(cuda)]["steps"][0]["launches"]
    assert all(launches.get(k, 0) > 0 for k in want), launches
    losses = [[r["loss"] for r in run["steps"]] for run in runs.values()]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


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


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("dim", [64, 37])
def test_dequant_unpack_kernel_bit_identical(cuda, bits, dim):
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
    want = SERVING + ("coarse_topm", "dequant_unpack", "sddmm")
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
