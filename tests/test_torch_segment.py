"""The attention's gathers with a deterministic backward (CPU, plain route).

``gather_rows`` is ``index_select`` forward; its backward sums each table
row's gradient over a grouping of the edges (``SegmentRuns`` levels) in a
fixed order, where ``index_select``'s own backward is ``index_add_``. Held
here against ``index_select`` and ``index_add_`` for the three groupings
the attention uses: by destination and by source (the layout's slot runs)
and by relation (``relation_runs``, chunked into levels), and against the
JAX package's gather backward (``jax.vjp`` of ``table[idx]``, XLA's
scatter-add). Tolerances: equal in float64 up to reassociation (1e-12
relative), 1e-6 relative in float32.
The CUDA route is held to this plain route by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.act import gather_rows
from repro_torch.data.csr import build_spmm_layout, relation_runs
from repro_torch.kernels import ops

N_NODES, N_REL, N_EDGES, CHUNK = 40, 7, 300, 8


def _graph(seed=0):
    """Zipf-skewed destinations (long runs and empty rows) and relations
    (relation 0 takes most edges; relation 5 none)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_NODES, N_EDGES)
    dst = np.minimum(rng.zipf(1.4, N_EDGES) - 1, N_NODES - 10)
    rel = np.minimum(rng.zipf(1.6, N_EDGES) - 1, N_REL - 1)
    rel[rel == 5] = 6
    layout = build_spmm_layout(src, dst, n_dst=N_NODES, block_e=16,
                               block_rows=8, device="cpu")
    runs = {"dst": (dst, layout.runs()),
            "src": (src, layout.runs(transpose=True)),
            "rel": (rel, relation_runs(rel, N_REL, chunk=CHUNK,
                                       device="cpu"))}
    return runs


def test_relation_runs_cover_every_edge_once_in_order():
    rel, levels = _graph()["rel"]
    assert len(levels) == 3                    # 2 chunk levels + relations
    first = levels[0]
    deg = (first.row_end - first.row_start).numpy()
    assert deg.max() == CHUNK and (deg > 0).all()
    slots = np.concatenate([np.arange(a, b) for a, b in
                            zip(first.row_start.numpy(),
                                first.row_end.numpy())])
    np.testing.assert_array_equal(slots, np.arange(N_EDGES))   # once each
    perm = first.perm.numpy()
    np.testing.assert_array_equal(rel[perm], np.sort(rel))     # rel order
    for r in range(N_REL):                     # edge ids ascend in a run
        ids = perm[rel[perm] == r]
        assert (np.diff(ids) > 0).all()
    for lo, hi in zip(levels, levels[1:]):     # each level sums the last
        assert hi.n_rows == lo.n_out and hi.perm.shape[0] == lo.n_out
        assert int((hi.row_end - hi.row_start).max()) <= CHUNK
    last = levels[-1]
    assert last.n_out == N_REL
    assert int(last.row_end[5] - last.row_start[5]) == 0       # empty
    assert int(np.bincount(rel).max()) > CHUNK * CHUNK          # 3 levels


@pytest.mark.parametrize("kind", ["dst", "src", "rel"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-6)])
@pytest.mark.parametrize("d", [0, 4, 5])
def test_gather_rows_matches_index_select_and_index_add(kind, dtype, rtol,
                                                        d):
    idx_np, runs = _graph()[kind]
    idx = torch.from_numpy(idx_np)
    n = N_REL if kind == "rel" else N_NODES
    rng = np.random.default_rng(d)
    shape = (n, d) if d else (n,)               # d 0: a 1-D table (den)
    table = torch.from_numpy(rng.normal(size=shape)).to(dtype)
    grad = torch.from_numpy(rng.normal(size=(N_EDGES,) + shape[1:])) \
        .to(dtype)
    t = table.clone().requires_grad_(True)
    out = gather_rows(t, idx, runs)
    assert torch.equal(out, table.index_select(0, idx))
    (got,) = torch.autograd.grad(out, t, grad)
    want = torch.zeros_like(table).index_add_(0, idx, grad)
    assert got.shape == table.shape and got.dtype == dtype
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rtol * scale
    if kind == "dst":                            # empty rows get 0
        empty = np.bincount(idx_np, minlength=n) == 0
        assert empty.any() and bool((got[torch.from_numpy(empty)] == 0)
                                    .all())


@pytest.mark.parametrize("kind", ["dst", "src", "rel"])
def test_gather_rows_backward_matches_jax(kind):
    idx_np, runs = _graph(1)[kind]
    n = N_REL if kind == "rel" else N_NODES
    rng = np.random.default_rng(2)
    table = rng.normal(size=(n, 6)).astype(np.float32)
    grad = rng.normal(size=(N_EDGES, 6)).astype(np.float32)
    out, vjp = jax.vjp(lambda t: t[jnp.asarray(idx_np)], jnp.asarray(table))
    (want,) = vjp(jnp.asarray(grad))
    t = torch.from_numpy(table).requires_grad_(True)
    got_out = gather_rows(t, torch.from_numpy(idx_np), runs)
    (got,) = torch.autograd.grad(got_out, t, torch.from_numpy(grad))
    np.testing.assert_array_equal(got_out.detach().numpy(), np.asarray(out))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_segment_sum_rejects_other_devices():
    _, runs = _graph()["dst"]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.segment_sum(torch.zeros((N_EDGES, 4), device="meta"), runs)
