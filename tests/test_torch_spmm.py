"""Port parity: blocked-CSR layout and SPMM against the JAX package.

Layout arrays must equal ``repro.data.csr.build_spmm_layout``'s, and the
port's own per-row slot runs (``row_start``/``row_end``, which the CUDA
kernel reads) must cover exactly each row's real slots; the plain SPMM must
be within 1e-6 of the JAX ``spmm`` (interpret-mode Pallas kernel) on the
same inputs: both sum fp32 products, in different orders. Also: the scoped
full-fp32 helper hands the caller's TF32 flag back.
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
from repro_torch.kernels.backend import full_fp32

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
        _check_row_runs(got, tr)


def dataclass_dict(m):
    return {k: getattr(m, k) for k in m.__dataclass_fields__}


def _check_row_runs(layout, transpose):
    """Every real slot of output row r lies in row_start[r] .. row_end[r],
    and no pad slot lies in any run."""
    m, dr = layout.meta, layout.direction(transpose)
    perm = dr.perm_blk.reshape(-1).numpy()
    rows = (np.repeat(dr.tile_of_blk.numpy(), m.block_e) * m.block_rows
            + dr.ldst_blk.reshape(-1).numpy())
    start, end = dr.row_start.numpy(), dr.row_end.numpy()
    assert start.shape == end.shape == (dr.n_out,)
    assert (start <= end).all()
    owner = np.full(perm.shape, -1)
    for r in np.flatnonzero(end > start):
        assert (owner[start[r]:end[r]] == -1).all()      # runs are disjoint
        owner[start[r]:end[r]] = r
    real = perm < m.n_edges
    np.testing.assert_array_equal(owner[real], rows[real])
    assert (owner[~real] == -1).all()
    return end - start


@pytest.mark.parametrize("transpose", [False, True])
def test_row_runs_cover_each_rows_slots(transpose):
    rng = np.random.default_rng(4)
    # zipf-skewed destinations: rows of 300+ slots beside empty ones
    dst = np.minimum(rng.zipf(1.3, 3000) - 1, 59)
    src = rng.integers(0, 80, 3000)
    layout = tcsr.build_spmm_layout(src, dst, n_dst=90, n_src=80,
                                    block_e=16, block_rows=8, device="cpu")
    deg = _check_row_runs(layout, transpose)
    want = np.bincount(src if transpose else dst,
                       minlength=80 if transpose else 90)
    np.testing.assert_array_equal(deg, want)
    if not transpose:
        assert deg.max() > 256 and (deg == 0).sum() >= 30


def test_full_fp32_restores_the_callers_tf32_flag():
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    try:
        for flag in (True, False):
            flags.allow_tf32 = flag
            with full_fp32():
                assert flags.allow_tf32 is False
            assert flags.allow_tf32 is flag
        flags.allow_tf32 = True
        with pytest.raises(KeyError), full_fp32():
            raise KeyError("the flag comes back on an error too")
        assert flags.allow_tf32 is True
    finally:
        flags.allow_tf32 = before


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
