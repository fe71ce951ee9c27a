"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs an NVIDIA Hopper GPU and nvcc, and skips
without them (the kernels have no CPU or interpret mode). Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Small shapes; ``chip_smoke.py`` repeats the checks at the serving path's
full-width shapes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.configs.smoke import reduced
from repro_torch.core.quant import QTensor, dequantize, pack_bits, quantize
from repro_torch.data.csr import build_spmm_layout
from repro_torch.kernels import backend
from repro_torch.kernels import quant_pack as qp
from repro_torch.kernels import spmm as sp
from repro_torch.kernels import topk_score as tk
from repro_torch.launch.serve import reduced_dataset, serve_kgnn
from repro_torch.models import kgnn

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
    assert all(counts.get(n, 0) > 0 for n in backend.SOURCES), counts
    assert res["dense_delta"] <= 1e-6
