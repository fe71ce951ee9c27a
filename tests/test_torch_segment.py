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

The segment-sum kernel's plan (``data.csr.segment_plan``): its items cover
every slot once, in order, in chunks of at most ``SEG_CHUNK`` slots at
run-relative offsets, and its tiles stay within what the kernel stages; a
numpy walk of the plan as the kernel walks it (tiles, empty rows, items,
partials, their sum in chunk order) gives, bit for bit, the chunk-order
contract's sums.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.act import gather_rows
from repro_torch.data.csr import SEG_CHUNK, SEG_TILE, build_spmm_layout, \
    relation_runs, segment_plan, segment_runs
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


# -- the segment-sum kernel's plan ------------------------------------------

C = SEG_CHUNK


def _gapped_runs(seed=0):
    """One level with runs of 0, 1, C, C + 1, 2C and 10C + 3 slots among
    short ones, gaps of pad slots (perm = n_rows) between some runs, as a
    layout has between its tiles."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([[0, 1, C, C + 1, 0, 0, 10 * C + 3, 5, 0, 2 * C],
                           rng.integers(0, 9, 300), [C, 0]])
    gaps = np.where(rng.random(len(lens)) < 0.2, rng.integers(1, 40,
                                                              len(lens)), 0)
    start = np.cumsum(np.concatenate([[0], (lens + gaps)[:-1]])) + gaps[0]
    n_rows = int(lens.sum())
    perm = np.full(int(start[-1] + lens[-1]), n_rows)
    for a, n, v in zip(start, lens, np.split(rng.permutation(n_rows),
                                             np.cumsum(lens)[:-1])):
        perm[a:a + n] = v
    return (segment_runs(perm, start, start + lens, len(lens), n_rows),)


def _groupings():
    """The levels the kernel sums over: gapped runs, a zipf graph's layout
    runs by destination and by source (hub rows of several chunks), and
    its relation levels."""
    rng = np.random.default_rng(3)
    n, e = 60, 9000
    src = rng.integers(0, n, e)
    dst = np.minimum(rng.zipf(1.3, e) - 1, n - 1)
    rel = np.minimum(rng.zipf(1.3, e) - 1, 6)
    layout = build_spmm_layout(src, dst, n_dst=n, block_e=32, block_rows=8,
                               device="cpu")
    return {"gapped": _gapped_runs(), "dst": layout.runs(),
            "src": layout.runs(transpose=True),
            "rel": relation_runs(rel, 8, chunk=16, device="cpu")}


def _seq_sum(rows: np.ndarray) -> np.ndarray:
    """float32 sum of ``rows`` in order from 0, one rounding an add."""
    z = np.zeros((1,) + rows.shape[1:], np.float32)
    return np.cumsum(np.concatenate([z, rows]), axis=0, dtype=np.float32)[-1]


def _np(runs):
    return (runs.perm.numpy().astype(np.int64),
            runs.row_start.numpy().astype(np.int64),
            runs.row_end.numpy().astype(np.int64))


def _contract(levels, y: np.ndarray) -> np.ndarray:
    """The kernel's contract, row by row: chunks of C slots at run-relative
    offsets each summed in slot order, a row's chunks in chunk order."""
    for runs in levels:
        perm, rs, re = _np(runs)
        out = np.zeros((runs.n_out,) + y.shape[1:], np.float32)
        for r in range(runs.n_out):
            parts = [_seq_sum(y[perm[c:min(c + C, re[r])]])
                     for c in range(rs[r], re[r], C)]
            if parts:
                out[r] = parts[0] if len(parts) == 1 else \
                    _seq_sum(np.stack(parts))
        y = out
    return y


def _emulate(levels, y: np.ndarray) -> np.ndarray:
    """The kernel's walk of each level's plan: per tile, the empty rows of
    its row range as zeros and each item's chunk summed into its row (or
    into its partial, for a row of several chunks); then each long row's
    partials in chunk order. Checks every row is written once and each
    tile's items lie in what the kernel stages for it."""
    for runs in levels:
        perm, rs, re = _np(runs)
        p = runs.plan
        ip, tiles = p.item_ptr.numpy(), p.tiles.numpy()
        long_rows, long_part = p.long_rows.numpy(), p.long_part.numpy()
        out = np.full((runs.n_out,) + y.shape[1:], np.nan, np.float32)
        parts = np.full((p.n_parts,) + y.shape[1:], np.nan, np.float32)
        written = np.zeros(runs.n_out, int)
        for t in range(p.n_tiles):
            (i0, i1), (r0, r1), (s0, s1) = tiles[:, t:t + 2]
            assert r1 - r0 <= SEG_TILE and s1 - s0 <= SEG_TILE + 2 * C
            for r in range(r0, r1):
                if ip[r + 1] == ip[r]:
                    out[r] = 0
                    written[r] += 1
            for gi in range(i0, i1):
                r = int(np.searchsorted(ip, gi, side="right")) - 1
                assert r0 <= r <= min(r1, runs.n_out - 1)
                k = gi - ip[r]
                a, b = rs[r] + k * C, min(rs[r] + (k + 1) * C, re[r])
                assert s0 <= a < b <= s1
                acc = _seq_sum(y[perm[a:b]])
                if ip[r + 1] - ip[r] == 1:
                    out[r] = acc
                    written[r] += 1
                else:
                    j = int(np.searchsorted(long_rows, r))
                    parts[long_part[j] + k] = acc
        for j, r in enumerate(long_rows):
            out[r] = _seq_sum(parts[long_part[j]:long_part[j + 1]])
            written[r] += 1
        assert (written == 1).all()
        y = out
    return y


@pytest.mark.parametrize("kind", ["gapped", "dst", "src", "rel"])
def test_segment_plan_items_cover_every_slot_once(kind):
    """Every slot of every run once, in order; chunks start at
    ``row_start + k*C`` and hold at most C slots; an empty row has no
    item; the tiles split the items and the rows into ranges that follow
    each other; the long rows are those of more than one chunk."""
    levels = _groupings()[kind]
    for runs in levels:
        perm, rs, re = _np(runs)
        p = runs.plan
        ip = p.item_ptr.numpy()
        deg = re - rs
        assert ip[0] == 0 and (np.diff(ip) == -(-deg // C)).all()
        got, want = [], []
        for r in range(runs.n_out):
            want.append(np.arange(rs[r], re[r]))
            for k in range(ip[r + 1] - ip[r]):
                a, b = rs[r] + k * C, min(rs[r] + (k + 1) * C, re[r])
                assert 0 < b - a <= C
                got.append(np.arange(a, b))
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.concatenate(want))
        tiles = p.tiles.numpy()
        assert tiles.shape == (3, p.n_tiles + 1)
        assert tiles[0, 0] == 0 and tiles[0, -1] == ip[-1]
        assert tiles[1, 0] == 0 and tiles[1, -1] == runs.n_out
        assert (np.diff(tiles, axis=1) >= 0).all()
        np.testing.assert_array_equal(p.long_rows.numpy(),
                                      np.flatnonzero(deg > C))
        assert p.n_parts == int((-(-deg[deg > C] // C)).sum())
    if kind in ("gapped", "dst"):
        assert levels[0].plan.n_parts > 0                 # long rows


@pytest.mark.parametrize("kind", ["gapped", "dst", "src", "rel"])
@pytest.mark.parametrize("d", [1, 4, 5])
def test_segment_plan_walk_gives_contract_bits(kind, d):
    """The kernel's walk of the plan sums each row as the contract says,
    bit for bit; a run of at most C slots is the plain loop over its
    slots; and the result is the segment sum (against ``index_add_`` in
    float64)."""
    levels = _groupings()[kind]
    rng = np.random.default_rng(d)
    y = rng.normal(size=(levels[0].n_rows, d)).astype(np.float32)
    got = _emulate(levels, y)
    np.testing.assert_array_equal(got, _contract(levels, y))
    if len(levels) == 1:
        perm, rs, re = _np(levels[0])
        short = np.flatnonzero(re - rs <= C)
        for r in short[:50]:
            np.testing.assert_array_equal(got[r], _seq_sum(y[perm[rs[r]:re[r]]]))
    want = ops.segment_sum(torch.from_numpy(y).double(), levels).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_segment_plan_refuses_overlapping_runs():
    with pytest.raises(ValueError, match="slot order"):
        segment_plan(np.array([0, 3]), np.array([5, 6]))
    p = segment_plan(np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert p.n_tiles == 0 and p.item_ptr.tolist() == [0]


def test_cuda_kernel_counts_add_and_reset():
    """A wrapper whose C entry point reports the CUDA kernels it started
    adds them to ``CUDA_KERNEL_COUNTS`` beside its one launch count;
    ``reset_counts`` clears both."""
    from repro_torch.kernels import backend

    backend.reset_counts()
    backend.count_launch("segment_sum", kernels=2)
    backend.count_launch("segment_sum", kernels=1)
    backend.count_launch("spmm")
    assert backend.LAUNCH_COUNTS == {"segment_sum": 2, "spmm": 1}
    assert backend.CUDA_KERNEL_COUNTS == {"segment_sum": 3}
    backend.reset_counts()
    assert not backend.LAUNCH_COUNTS and not backend.CUDA_KERNEL_COUNTS
