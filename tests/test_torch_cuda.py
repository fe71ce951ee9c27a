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
from repro_torch.models.registry import build_step
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scorer import quantize_query, two_stage_topk
from repro_torch.serving.store import QuantizedEmbeddingStore
from repro_torch.training.step import make_train_step, trainable

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
    """The plan's launch count, read from the profiler: one scan and one
    merge at m <= 128, 1 + ceil(log2(tiles)) at m > 128."""
    from torch.profiler import ProfilerActivity, profile

    q, items, excl = _ragged_case(cuda, 8, 8, 64, 7)
    q8, qmeta = quantize_query(q)
    for m in (20, 128, 200):
        for run, coarse in ((lambda: tk.topk_cuda(q, items, excl, k=m),
                             False),
                            (lambda: tk.coarse_topm_cuda(q8, qmeta, items,
                                                         excl, m=m), True)):
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and ("scan_kernel" in e.name or "merge_" in e.name)]
            p = tk.plan_for(8, items, m, device=cuda, coarse=coarse)
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
    tail = [v.data_ptr(), i.data_ptr(), backend.stream_of(q)]
    assert fn(*args, p.scratch_bytes - 8, *tail) != 0
    assert fn(*args, p.scratch_bytes, *tail) == 0
    pv, pi = tk.topk_plain(q, items, excl, k=20)
    assert torch.equal(v, pv) and torch.equal(i, pi)


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
    for a, b in zip(grads[True], grads[False]):     # index_add_'s atomics
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


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
