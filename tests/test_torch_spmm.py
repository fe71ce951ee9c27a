"""Port parity: blocked-CSR layout and SPMM against the JAX package.

Layout arrays must equal ``repro.data.csr.build_spmm_layout``'s; the plain
SPMM must be within 1e-6 of the JAX ``spmm`` (interpret-mode Pallas kernel)
on the same inputs: both sum fp32 products, in different orders.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import csr as jcsr
from repro.kernels import spmm as jspmm
from repro_torch.data import csr as tcsr
from repro_torch.kernels import ops as tops

_FIELDS = ("src_blk", "dstg_blk", "ldst_blk", "perm_blk", "tile_of_blk",
           "t_src_blk", "t_ldst_blk", "t_perm_blk", "t_tile_of_blk")


def _graph(n_src, n_dst, n_edges, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, n_edges)
    # destinations in the first two thirds: the last tiles get no edges
    dst = rng.integers(0, 2 * n_dst // 3, n_edges)
    return src, dst


@pytest.mark.parametrize("block_e,block_rows", [(16, 8), (256, 256)])
def test_layout_arrays_equal_jax(block_e, block_rows):
    src, dst = _graph(70, 90, 400, 0)
    kw = dict(n_dst=90, n_src=70, block_e=block_e, block_rows=block_rows)
    ref = jcsr.build_spmm_layout(src, dst, **kw)
    got = tcsr.build_spmm_layout(src, dst, device="cpu", **kw)
    assert dataclass_dict(got.meta) == dataclass_dict(ref.meta)
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for tr in (False, True):
        dr = got.direction(tr)
        # tile_ptr: tile t owns blocks [tile_ptr[t], tile_ptr[t+1])
        tp, tof = dr.tile_ptr.numpy(), dr.tile_of_blk.numpy()
        assert tp[0] == 0 and tp[-1] == len(tof) and len(tp) == dr.n_tiles + 1
        for t in range(dr.n_tiles):
            assert (tof[tp[t]:tp[t + 1]] == t).all() and tp[t + 1] > tp[t]


def dataclass_dict(m):
    return {k: getattr(m, k) for k in m.__dataclass_fields__}


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_plain_matches_jax(weighted, transpose):
    n_src, n_dst, d = 70, 90, 24
    src, dst = _graph(n_src, n_dst, 400, 1)
    layout_j = jcsr.build_spmm_layout(src, dst, n_dst=n_dst, n_src=n_src,
                                      block_e=16, block_rows=8)
    layout_t = tcsr.build_spmm_layout(src, dst, n_dst=n_dst, n_src=n_src,
                                      block_e=16, block_rows=8, device="cpu")
    rng = np.random.default_rng(2)
    # embedding-scale rows (std 0.1) and attention-scale weights
    x = (0.1 * rng.normal(size=(n_dst if transpose else n_src, d))
         ).astype(np.float32)
    ew = rng.uniform(0.0, 0.5, len(src)).astype(np.float32) \
        if weighted else None
    ref = np.asarray(jspmm.spmm(jnp.asarray(x),
                                None if ew is None else jnp.asarray(ew),
                                layout_j, transpose=transpose, block_d=128,
                                interpret=True))
    got = tops.spmm(torch.from_numpy(x),
                    None if ew is None else torch.from_numpy(ew),
                    layout_t, transpose=transpose).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # and the COO definition, summed in float64
    w = np.ones(len(src)) if ew is None else ew.astype(np.float64)
    a, b = (dst, src) if transpose else (src, dst)
    coo = np.zeros(ref.shape)
    np.add.at(coo, b, x[a].astype(np.float64) * w[:, None])
    np.testing.assert_allclose(got, coo, rtol=0, atol=1e-6)


def test_spmm_rejects_other_devices():
    src, dst = _graph(10, 10, 30, 3)
    layout = tcsr.build_spmm_layout(src, dst, n_dst=10, device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.spmm(torch.zeros((10, 4), device="meta"), None, layout)
