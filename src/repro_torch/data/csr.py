"""Blocked-CSR edge layout for the SPMM kernel (port of ``repro/data/csr.py``).

Built once per graph on the host with numpy, making the same numpy calls in
the same order as the JAX package, so the arrays are identical
(DESIGN.md section 4):

1. Stable-sort edges by destination.
2. Tile destinations into ``block_rows`` rows; pad each tile's run of edges
   to a multiple of ``block_e`` slots, and give an edgeless tile one all-pad
   block. A tile's real edges come first, its pad slots after them.
3. Emit per-slot arrays ``(n_blocks, block_e)`` and ``tile_of_blk``.

Pad slots carry ``perm = n_edges``, so ``append(ew, 0)[perm]`` puts the edge
weights in slot order and zeroes the pads. The transpose direction (edges
sorted by source) comes from the same builder run on the reversed edges.
With ``pad_static=True`` each direction is padded to ``static_block_caps``
blocks by all-pad blocks appended to the last tile, so every layout of one
(edge count, row counts, block sizes) has the same geometry: the sampled
minibatch path's blocks (``data.minibatch``).

The port adds, for each direction, the slot run of every output row:
``row_start[r] .. row_end[r]`` are the slots of row ``r``'s edges (empty
rows have ``row_start == row_end``). A tile's real slots are sorted by
destination and its pad slots come after them, and the static pad blocks
come after every tile's slots, so each run is contiguous and holds no pad
slot. The CUDA SPMM kernel gives each row a warp and finds
its slots through these two arrays.

Every grouping a fixed-order segment sum runs over (``SegmentRuns``: a
direction of the layout, ``relation_runs``, the tier store's and the row
blocks' positions) carries its ``SegmentPlan``, built here on the host
beside its row pointers (``segment_runs``, ``segment_plan``): how the
segment-sum kernel (``csrc/segment_sum.cu``) cuts each row's run into
chunks of ``SEG_CHUNK`` slots and deals the chunks and the empty rows out
to tiles of ``SEG_TILE`` rows and slot positions. The runs of a grouping
lie in slot order and do not overlap.

For several ranks (``training.data_parallel``) the edges are split by
destination shard once on the host (``partition_edges``, the reference's
arrays exactly) and each shard's edges get their own layout and relation
grouping (``shard_graph_arrays``); ``row_partition`` is the row-block
geometry of a table stored across the ``model`` ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["CSRMeta", "SpmmLayout", "Direction", "SegmentRuns",
           "SegmentPlan", "segment_plan", "segment_runs", "SEG_CHUNK",
           "SEG_TILE", "static_block_caps", "build_spmm_layout", "relation_runs",
           "attach_layout", "map_tensors", "to_device", "stable_argsort",
           "group_ids", "LookupPlan", "lookup_plan", "EdgePartition",
           "partition_edges", "unpartition_edges", "shard_graph_arrays",
           "RowPartition", "row_partition"]

REL_CHUNK = 256   # slots a relation chunk holds (relation_runs)
# the segment-sum kernel's contract and work split (csrc/segment_sum.cu
# kChunk and kTile: change them together)
SEG_CHUNK = 256   # slots a chunk of a run holds; chunks sum in chunk order
SEG_TILE = 512    # rows plus slot positions one tile of the kernel covers
_CHUNK_SHIFT = SEG_CHUNK.bit_length() - 1   # SEG_CHUNK is a power of two


@dataclasses.dataclass(frozen=True)
class CSRMeta:
    """Block geometry of one layout."""

    n_src: int        # rows of the gathered-from table (x fwd, g bwd)
    n_dst: int        # output segment count of the forward aggregation
    n_edges: int      # real (unpadded) edge count E
    block_e: int      # edge slots per block
    block_rows: int   # destination rows per output tile
    n_blocks: int     # forward-direction edge blocks (incl. pad blocks)
    n_tiles: int      # forward-direction destination tiles
    t_n_blocks: int   # transpose-direction edge blocks
    t_n_tiles: int    # transpose-direction tiles (cover n_src rows)


@dataclasses.dataclass(frozen=True)
class Direction:
    """One aggregation direction's arrays, as the SPMM kernel takes them."""

    gat_blk: torch.Tensor     # (n_blocks, block_e) rows of the gathered table
    ldst_blk: torch.Tensor    # (n_blocks, block_e) output row local to tile
    perm_blk: torch.Tensor    # (n_blocks, block_e) edge index; n_edges = pad
    tile_of_blk: torch.Tensor  # (n_blocks,)
    row_start: torch.Tensor   # (n_out,) first slot of each output row
    row_end: torch.Tensor     # (n_out,) one past its last slot
    n_tiles: int
    n_out: int


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """How the segment-sum kernel splits one level (``segment_plan``).

    An item is one chunk of a row's run: slots ``row_start[r] + k *
    SEG_CHUNK`` up to ``SEG_CHUNK`` further, cut off at ``row_end[r]``;
    row ``r`` owns items ``item_ptr[r] .. item_ptr[r + 1]`` (none when its
    run is empty). Tile ``t`` takes items ``tiles[0, t] .. tiles[0, t +
    1]``, writes the empty rows among ``tiles[1, t] .. tiles[1, t + 1]``
    as zeros, and reads the run slots from ``tiles[2, t]`` on. A row of
    more than one chunk (``long_rows``) sums each chunk into its partials,
    ``long_part[j] + k``, and a second kernel adds them in chunk order."""

    item_ptr: torch.Tensor    # (n_out + 1,) int32
    tiles: torch.Tensor       # (3, n_tiles + 1) int32: item, row, slot
    long_rows: torch.Tensor   # (n_long,) int32, ascending
    long_part: torch.Tensor   # (n_long + 1,) int32
    n_tiles: int
    n_parts: int              # partials of the long rows


@dataclasses.dataclass(frozen=True)
class SegmentRuns:
    """One level of a fixed-order segment sum over ``n_rows`` input rows:
    output row ``r`` is the sum of input rows ``perm[s]`` for slots
    ``row_start[r] <= s < row_end[r]``; each chunk of ``SEG_CHUNK`` slots
    of a run (at run-relative offsets) is summed in slot order, and the
    chunks' sums in chunk order, so a run of at most ``SEG_CHUNK`` slots is
    one sum in slot order. A grouping is a tuple of levels, each summing
    the previous level's output. ``plan`` is the kernel's work split."""

    perm: torch.Tensor        # (n_slots,) int32 input row of each slot
    row_start: torch.Tensor   # (n_out,) int32
    row_end: torch.Tensor     # (n_out,) int32
    n_out: int
    n_rows: int
    plan: SegmentPlan


@dataclasses.dataclass(frozen=True)
class SpmmLayout:
    """Blocked-CSR slots for one graph, forward and transpose directions.

    All arrays int32 on one device; ``*_blk`` arrays are
    ``(n_blocks, block_e)``; pad slots hold gather index 0, local row 0 and
    perm ``n_edges``.
    """

    # forward direction: edges stable-sorted by dst
    src_blk: torch.Tensor     # global src id per slot: rows of x
    dstg_blk: torch.Tensor    # global dst id per slot: rows of g (SDDMM)
    ldst_blk: torch.Tensor    # dst id local to its tile
    perm_blk: torch.Tensor    # original edge index per slot; n_edges for pads
    tile_of_blk: torch.Tensor  # (n_blocks,) destination tile per block
    row_start: torch.Tensor   # (n_dst,) slot run of each destination row
    row_end: torch.Tensor     # (n_dst,)
    # transpose direction: edges stable-sorted by src (drives the gradient)
    t_src_blk: torch.Tensor   # global dst id per slot: rows of g
    t_ldst_blk: torch.Tensor  # src id local to its tile
    t_perm_blk: torch.Tensor
    t_tile_of_blk: torch.Tensor
    t_row_start: torch.Tensor  # (n_src,) slot run of each source row
    t_row_end: torch.Tensor
    meta: CSRMeta
    plan: SegmentPlan          # segment-sum split of the dst runs
    t_plan: SegmentPlan        # and of the src runs
    # the distinct rows the edges gather, forward (of x) and transpose (of
    # g): the rows an SPMM in that direction reads (``spmm_cost``)
    rows_read: tuple[int, int]

    def direction(self, transpose: bool = False) -> Direction:
        m = self.meta
        if transpose:
            return Direction(self.t_src_blk, self.t_ldst_blk, self.t_perm_blk,
                             self.t_tile_of_blk, self.t_row_start,
                             self.t_row_end, m.t_n_tiles, m.n_src)
        return Direction(self.src_blk, self.ldst_blk, self.perm_blk,
                         self.tile_of_blk, self.row_start, self.row_end,
                         m.n_tiles, m.n_dst)

    def in_degree(self) -> torch.Tensor:
        """(n_dst,) int32: the number of edges into each destination row."""
        return self.row_end - self.row_start

    def runs(self, transpose: bool = False) -> tuple:
        """The one-level grouping of the edges by destination (by source
        for ``transpose=True``): the backward of a gather by ``dst``
        (``src``)."""
        dr = self.direction(transpose)
        return (SegmentRuns(dr.perm_blk.reshape(-1), dr.row_start,
                            dr.row_end, dr.n_out, self.meta.n_edges,
                            self.t_plan if transpose else self.plan),)


def stable_argsort(keys, n_keys: int) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` of integer keys in
    ``[0, n_keys)``: the same permutation, from one or two stable sorts of
    16-bit digits, which numpy sorts by radix in linear time (the sampled
    path sorts hundreds of thousands of ids a batch)."""
    keys = np.asarray(keys)
    if not keys.size or n_keys > 1 << 32 or keys.min() < 0 \
            or keys.max() >= n_keys:
        return np.argsort(keys, kind="stable")
    if n_keys <= 1 << 16:
        return np.argsort(keys.astype(np.uint16), kind="stable")
    lo = np.argsort((keys & 0xFFFF).astype(np.uint16), kind="stable")
    hi = (keys[lo] >> 16).astype(np.uint16)
    return lo[np.argsort(hi, kind="stable")]


def group_ids(ids, n_ids: int):
    """The groups of equal integer ids in ``[0, n_ids)``: ``(uniq, first,
    inv, order, counts)``, where ``uniq``, ``first``, ``inv`` and
    ``counts`` are ``np.unique(ids, return_index=True,
    return_inverse=True, return_counts=True)``'s and ``order`` is the
    stable sort of ``ids`` (each group's positions in position order, the
    groups in ``uniq``'s)."""
    ids = np.asarray(ids).reshape(-1)
    order = stable_argsort(ids, n_ids)
    s = ids[order]
    head = np.empty(len(s), bool)
    head[:1] = True
    np.not_equal(s[1:], s[:-1], out=head[1:])
    starts = np.nonzero(head)[0]
    inv = np.empty(len(s), np.int64)
    inv[order] = np.cumsum(head) - 1
    return (s[starts], order[starts], inv, order,
            np.diff(np.append(starts, len(s))))


def map_tensors(obj, fn):
    """A copy of a layout, a ``SegmentRuns`` level or a tuple of them with
    ``fn`` applied to every tensor (their ``SegmentPlan``s' too)."""
    if isinstance(obj, tuple):
        return tuple(map_tensors(o, fn) for o in obj)
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = fn(v)
        elif isinstance(v, SegmentPlan):
            out[f.name] = map_tensors(v, fn)
    return dataclasses.replace(obj, **out)


def segment_plan(row_start, row_end, device="cpu") -> SegmentPlan:
    """The segment-sum kernel's split of one level (see ``SegmentPlan``),
    from its row pointers (numpy): chunk counts and their prefix sum
    (``item_ptr``), then ``SEG_TILE``-wide tiles of the cost ``r +
    row_start[r]`` (a row's write plus its run's slot positions, which
    rises by at least one a row since the runs lie in slot order). A tile
    starts at the first chunk at or past its cost, so it holds at most
    ``SEG_TILE + 1`` rows and its chunks' slots lie within ``SEG_TILE + 2 *
    SEG_CHUNK`` of its first slot (the kernel stages that much). A few
    int32 passes over the rows, in place where they can be (the sampled
    path builds one for each grouping of a batch, in the sampler thread)."""
    rs = np.asarray(row_start).astype(np.int32, copy=False)
    re = np.asarray(row_end).astype(np.int32, copy=False)
    n_out = int(rs.shape[0])
    n_ch = re - rs
    if n_out and (n_ch.min() < 0 or (rs[1:] < re[:-1]).any()):
        raise ValueError("segment runs must lie in slot order and not "
                         "overlap")
    n_ch += SEG_CHUNK - 1
    n_ch >>= _CHUNK_SHIFT
    item_ptr = torch.zeros(n_out + 1, dtype=torch.int32)
    torch.cumsum(torch.from_numpy(n_ch), 0, out=item_ptr[1:])
    ip = item_ptr.numpy()
    end = int(re[-1]) if n_out else 0
    n_tiles = -(-(n_out + end) // SEG_TILE) if n_out else 0
    cost = rs + np.arange(n_out, dtype=np.int32)
    target = np.arange(0, n_tiles * SEG_TILE, SEG_TILE, dtype=np.int32)
    r = np.maximum(np.searchsorted(cost, target, side="right") - 1, 0)
    k = np.clip(-((cost[r] - target) // SEG_CHUNK), 0, n_ch[r])
    tiles = np.stack([
        np.append(ip[r] + k, ip[-1]),
        np.append(r, n_out),
        np.append(np.minimum(rs[r] + k * SEG_CHUNK, re[r]), end)])
    long_rows = np.flatnonzero(n_ch > 1)
    long_part = np.zeros(len(long_rows) + 1, np.int64)
    np.cumsum(n_ch[long_rows], out=long_part[1:])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            device, non_blocking=True)

    return SegmentPlan(item_ptr.to(device, non_blocking=True), t(tiles),
                       t(long_rows), t(long_part), n_tiles,
                       int(long_part[-1]))


def segment_runs(perm, row_start, row_end, n_out: int, n_rows: int,
                 device="cpu") -> SegmentRuns:
    """One ``SegmentRuns`` level on ``device`` from numpy arrays, with its
    kernel plan (copies queued without waiting for the device)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            device, non_blocking=True)

    return SegmentRuns(t(perm), t(row_start), t(row_end), int(n_out),
                       int(n_rows), segment_plan(row_start, row_end, device))


@dataclasses.dataclass(frozen=True)
class LookupPlan:
    """A batch's table rows and their grouping for an embedding lookup's
    backward (``core.act.lookup_rows``): ``ids`` the flat rows, ``rows``
    the distinct rows (ascending) and ``runs`` one ``SegmentRuns`` level
    whose output row ``r`` sums the positions of ``rows[r]`` in position
    order."""

    ids: torch.Tensor      # (n_ids,) int64
    rows: torch.Tensor     # (n_distinct,) int64
    runs: tuple


def lookup_plan(flat_ids, n_rows: int, device="cpu") -> LookupPlan:
    """The ``LookupPlan`` of a batch's flat table rows (numpy, in ``[0,
    n_rows)``), built on the host in O(len) and moved to ``device`` without
    waiting."""
    flat = np.asarray(flat_ids, np.int64).reshape(-1)
    uniq, _, _, order, counts = group_ids(flat, n_rows)
    end = np.cumsum(counts)
    runs = (segment_runs(order, end - counts, end, len(uniq), len(flat),
                         device),)
    return LookupPlan(torch.from_numpy(flat).to(device, non_blocking=True),
                      torch.from_numpy(uniq.astype(np.int64)).to(
                          device, non_blocking=True), runs)


def to_device(obj, device):
    """``map_tensors`` moving every tensor to ``device`` (asynchronously
    from pinned host memory)."""
    return map_tensors(obj, lambda t: t.to(device, non_blocking=True))


def static_block_caps(n_edges: int, n_out: int, *, block_e: int = 256,
                      block_rows: int = 256) -> int:
    """The most blocks ``_build_direction`` makes for any assignment of
    ``n_edges`` edges to ``n_out`` output rows: each tile wastes less than
    one block and makes at least one, so
    ``sum_i ceil(c_i / block_e) <= floor(E / block_e) + n_tiles``."""
    n_tiles = max(1, -(-n_out // block_rows))
    return n_edges // block_e + n_tiles


def _build_direction(gather_ids: np.ndarray, out_ids: np.ndarray,
                     n_out: int, block_e: int, block_rows: int,
                     pad_to_blocks: int | None = None):
    """Slot arrays for one aggregation direction (into ``n_out`` rows).
    ``pad_to_blocks`` appends all-pad blocks (``perm == n_edges``) to the
    last tile until the layout has that many; they lie after every row's
    run."""
    E = int(out_ids.shape[0])
    n_tiles = max(1, -(-n_out // block_rows))
    order = stable_argsort(out_ids, n_out).astype(np.int64)
    gat_s = gather_ids[order]
    out_s = out_ids[order]
    tile_of_edge = out_s // block_rows

    counts = np.bincount(tile_of_edge, minlength=n_tiles)
    blocks_per_tile = np.maximum(1, -(-counts // block_e))
    n_blocks = int(blocks_per_tile.sum())
    cap = blocks_per_tile * block_e                       # slots per tile
    tile_slot0 = np.concatenate([[0], np.cumsum(cap)[:-1]])
    edge_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = tile_slot0[tile_of_edge] + (np.arange(E) - edge_start[tile_of_edge])

    total = n_blocks * block_e
    gat_blk = np.zeros(total, np.int32)
    outg_blk = np.zeros(total, np.int32)
    lrow_blk = np.zeros(total, np.int32)
    perm_blk = np.full(total, E, np.int32)
    gat_blk[slot] = gat_s
    outg_blk[slot] = out_s
    lrow_blk[slot] = out_s - tile_of_edge * block_rows
    perm_blk[slot] = order
    tile_of_blk = np.repeat(np.arange(n_tiles, dtype=np.int32),
                            blocks_per_tile)
    if pad_to_blocks is not None:
        if n_blocks > pad_to_blocks:
            raise ValueError(
                f"layout needs {n_blocks} blocks, static cap is "
                f"{pad_to_blocks} (E={E}, n_out={n_out})")
        extra = pad_to_blocks - n_blocks
        if extra:
            pad = extra * block_e
            gat_blk = np.concatenate([gat_blk, np.zeros(pad, np.int32)])
            outg_blk = np.concatenate([outg_blk, np.zeros(pad, np.int32)])
            lrow_blk = np.concatenate([lrow_blk, np.zeros(pad, np.int32)])
            perm_blk = np.concatenate([perm_blk, np.full(pad, E, np.int32)])
            tile_of_blk = np.concatenate([
                tile_of_blk, np.full(extra, n_tiles - 1, np.int32)])
        n_blocks = pad_to_blocks
    # row r's edges are sorted positions first[r] .. first[r] + deg[r]; its
    # tile places them from tile_slot0 on, in that order
    deg = np.bincount(out_s, minlength=n_out)[:n_out]
    first = np.concatenate([[0], np.cumsum(deg)[:-1]])
    row_tile = np.arange(n_out) // block_rows
    row_start = tile_slot0[row_tile] + first - edge_start[row_tile]
    shape = (n_blocks, block_e)
    return (gat_blk.reshape(shape), outg_blk.reshape(shape),
            lrow_blk.reshape(shape), perm_blk.reshape(shape),
            tile_of_blk, row_start.astype(np.int32),
            (row_start + deg).astype(np.int32), n_blocks, n_tiles)


def _n_distinct(ids, n: int) -> int:
    return int(np.count_nonzero(np.bincount(ids, minlength=n)))


def build_spmm_layout(src, dst, *, n_dst: int, n_src: int | None = None,
                      block_e: int = 256, block_rows: int = 256,
                      pad_static: bool = False, device="cuda") -> SpmmLayout:
    """One-time host-side preprocessing of a COO edge list; the arrays land
    on ``device``. ``pad_static`` pads both directions to
    ``static_block_caps`` blocks (the sampled blocks' fixed geometry)."""
    from repro_torch.kernels.backend import resolve_device

    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"bad edge list shapes {src.shape}/{dst.shape}")
    n_src = int(n_src if n_src is not None else n_dst)
    E = int(src.shape[0])

    def cap(n_out):
        return static_block_caps(E, n_out, block_e=block_e,
                                 block_rows=block_rows) if pad_static else None

    (src_blk, dstg_blk, ldst_blk, perm_blk, tile_of_blk, row_start, row_end,
     n_blocks, n_tiles) = _build_direction(src, dst, n_dst,
                                           block_e, block_rows, cap(n_dst))
    (t_src_blk, _t_outg, t_ldst_blk, t_perm_blk, t_tile_of_blk, t_row_start,
     t_row_end, t_n_blocks, t_n_tiles) = _build_direction(
        dst, src, n_src, block_e, block_rows, cap(n_src))
    if max(n_blocks, t_n_blocks) * block_e >= 2**31:
        raise ValueError("layout slot count exceeds int32 indexing")
    meta = CSRMeta(n_src=n_src, n_dst=int(n_dst), n_edges=E,
                   block_e=block_e, block_rows=block_rows,
                   n_blocks=n_blocks, n_tiles=n_tiles,
                   t_n_blocks=t_n_blocks, t_n_tiles=t_n_tiles)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return SpmmLayout(
        src_blk=t(src_blk), dstg_blk=t(dstg_blk), ldst_blk=t(ldst_blk),
        perm_blk=t(perm_blk), tile_of_blk=t(tile_of_blk),
        row_start=t(row_start), row_end=t(row_end),
        t_src_blk=t(t_src_blk), t_ldst_blk=t(t_ldst_blk),
        t_perm_blk=t(t_perm_blk), t_tile_of_blk=t(t_tile_of_blk),
        t_row_start=t(t_row_start), t_row_end=t(t_row_end),
        meta=meta, plan=segment_plan(row_start, row_end, dev),
        t_plan=segment_plan(t_row_start, t_row_end, dev),
        rows_read=(_n_distinct(src, n_src), _n_distinct(dst, n_dst)))


def relation_runs(rel, n_relations: int, *, chunk: int = REL_CHUNK,
                  device="cuda") -> tuple:
    """The grouping of the edges by relation id (see the module docstring):
    levels of ``SegmentRuns`` whose runs hold at most ``chunk`` slots, the
    last with one run per relation (empty for an unused relation)."""
    from repro_torch.kernels.backend import resolve_device

    dev = resolve_device(device)
    rel = np.asarray(rel, dtype=np.int64)
    if chunk < 2:
        raise ValueError(f"chunk must be at least 2, got {chunk}")
    perm = stable_argsort(rel, n_relations)
    counts = np.bincount(rel, minlength=n_relations)[:n_relations]
    n_rows = int(rel.shape[0])

    levels = []
    while True:
        start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        if counts.max(initial=0) <= chunk:
            levels.append(segment_runs(perm, start, start + counts,
                                       n_relations, n_rows, dev))
            return tuple(levels)
        # cut every run into chunks of `chunk` slots; the next level sums
        # each relation's chunks, in order
        n_ch = -(-counts // chunk)
        owner = np.repeat(np.arange(n_relations), n_ch)
        first = np.concatenate([[0], np.cumsum(n_ch)[:-1]])
        c0 = start[owner] + (np.arange(int(n_ch.sum())) - first[owner]) * chunk
        c1 = np.minimum(c0 + chunk, (start + counts)[owner])
        levels.append(segment_runs(perm, c0, c1, len(c0), n_rows, dev))
        perm, counts, n_rows = np.arange(len(c0)), n_ch, len(c0)


def attach_layout(g, *, block_e: int = 256, block_rows: int = 256):
    """A copy of a graph dataclass (``models.kgnn.CKG``) with its ``layout``
    built from its COO edge list and its ``rel_runs`` from its relation ids
    (``relation_runs``), on the graph's device."""
    layout = build_spmm_layout(
        g.src.cpu().numpy(), g.dst.cpu().numpy(), n_dst=g.n_nodes,
        block_e=block_e, block_rows=block_rows, device=g.src.device)
    rel_runs = relation_runs(g.rel.cpu().numpy(), g.n_relations,
                             device=g.src.device)
    return dataclasses.replace(g, layout=layout, rel_runs=rel_runs)


# -- several ranks: the edges split by destination shard ----------------------


@dataclasses.dataclass(frozen=True)
class EdgePartition:
    """Edges split by destination shard (port of
    ``repro/data/csr.py:EdgePartition``): host numpy arrays, one row a
    shard, padded to one edge capacity ``e_cap`` and one halo capacity
    ``h_cap`` (pad edges have ``mask == 0``, ``perm == n_edges`` and their
    endpoints at 0). ``src_h`` indexes the shard's ``halo``, the unique
    global sources it reads; ``dst_l`` is local to its ``rows_per_shard``
    rows. Within a shard the edges keep their original relative order."""

    src_g: np.ndarray       # (S, Ec) int32 global source ids (pads: 0)
    src_h: np.ndarray       # (S, Ec) int32 halo-local source index
    dst_l: np.ndarray       # (S, Ec) int32 destination row local to the shard
    rel: np.ndarray         # (S, Ec) int32 relation ids (pads: 0)
    mask: np.ndarray        # (S, Ec) float32 1 = real edge, 0 = pad
    perm: np.ndarray        # (S, Ec) int32 original edge index; pads n_edges
    halo: np.ndarray        # (S, Hc) int32 unique global sources per shard
    halo_count: np.ndarray  # (S,) int32 real halo rows (the rest repeat 0)
    n_shards: int = 1
    rows_per_shard: int = 0
    n_nodes: int = 0        # original (unpadded) node count
    n_edges: int = 0

    @property
    def n_nodes_padded(self) -> int:
        return self.n_shards * self.rows_per_shard

    @property
    def e_cap(self) -> int:
        return int(self.src_g.shape[1])

    @property
    def h_cap(self) -> int:
        return int(self.halo.shape[1])

    def edge_counts(self) -> np.ndarray:
        """(S,) real edges of each shard."""
        return (self.perm < self.n_edges).sum(axis=1)


def partition_edges(src, dst, rel=None, *, n_nodes: int, n_shards: int,
                    pad_multiple: int = 8) -> EdgePartition:
    """Split a COO edge list by destination shard (host-side, once): the
    reference's numpy calls in its order, so the arrays are equal."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    rel = np.zeros_like(src) if rel is None else np.asarray(rel, np.int64)
    if not (src.shape == dst.shape == rel.shape) or src.ndim != 1:
        raise ValueError(
            f"bad edge list shapes {src.shape}/{dst.shape}/{rel.shape}")
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards}")
    if src.size and not (0 <= src.min() and src.max() < n_nodes
                         and 0 <= dst.min() and dst.max() < n_nodes):
        # an out-of-range dst would fall in no shard and vanish silently
        raise ValueError(
            f"edge endpoints outside [0, {n_nodes}): src range "
            f"[{src.min()}, {src.max()}], dst range "
            f"[{dst.min()}, {dst.max()}]")
    E = int(src.shape[0])
    rows = -(-n_nodes // n_shards)            # ceil; node space pads to S*rows
    shard_of = dst // rows
    per = [np.flatnonzero(shard_of == s) for s in range(n_shards)]
    e_cap = max(1, max((len(ix) for ix in per), default=1))
    e_cap = -(-e_cap // pad_multiple) * pad_multiple

    halos = [np.unique(src[ix]) if len(ix) else np.zeros(1, np.int64)
             for ix in per]
    h_cap = max(1, max(len(h) for h in halos))
    h_cap = -(-h_cap // pad_multiple) * pad_multiple

    src_g = np.zeros((n_shards, e_cap), np.int32)
    src_h = np.zeros((n_shards, e_cap), np.int32)
    dst_l = np.zeros((n_shards, e_cap), np.int32)
    rel_a = np.zeros((n_shards, e_cap), np.int32)
    mask = np.zeros((n_shards, e_cap), np.float32)
    perm = np.full((n_shards, e_cap), E, np.int32)
    halo = np.zeros((n_shards, h_cap), np.int32)
    halo_n = np.zeros((n_shards,), np.int32)
    for s, ix in enumerate(per):
        k = len(ix)
        src_g[s, :k] = src[ix]
        src_h[s, :k] = np.searchsorted(halos[s], src[ix])
        dst_l[s, :k] = dst[ix] - s * rows
        rel_a[s, :k] = rel[ix]
        mask[s, :k] = 1.0
        perm[s, :k] = ix
        halo[s, :len(halos[s])] = halos[s]
        halo_n[s] = len(halos[s])
    return EdgePartition(
        src_g=src_g, src_h=src_h, dst_l=dst_l, rel=rel_a, mask=mask,
        perm=perm, halo=halo, halo_count=halo_n, n_shards=n_shards,
        rows_per_shard=int(rows), n_nodes=int(n_nodes), n_edges=E)


def unpartition_edges(part: EdgePartition):
    """The original (src, dst, rel) COO lists from a partition: pad slots
    dropped, real edges back at their original positions."""
    E = part.n_edges
    perm = np.asarray(part.perm).ravel()
    keep = perm < E
    if int(keep.sum()) != E:
        raise ValueError(
            f"partition covers {int(keep.sum())} edges, expected {E}")
    src = np.zeros(E, np.int32)
    dst = np.zeros(E, np.int32)
    rel = np.zeros(E, np.int32)
    shard_ix = np.repeat(np.arange(part.n_shards), part.e_cap)[keep]
    p = perm[keep]
    src[p] = np.asarray(part.src_g).ravel()[keep]
    dst[p] = (np.asarray(part.dst_l).ravel()[keep]
              + shard_ix * part.rows_per_shard)
    rel[p] = np.asarray(part.rel).ravel()[keep]
    return src, dst, rel


def shard_graph_arrays(part: EdgePartition, s: int, n_relations: int, *,
                       block_e: int = 256, block_rows: int = 256,
                       device="cuda") -> dict:
    """Shard ``s``'s edges as the layers take them, on ``device``: ``src``
    (halo-local), ``dst`` (shard-local), ``rel``, ``mask``, the blocked-CSR
    ``layout`` (``n_src = h_cap`` halo rows, ``n_dst = rows_per_shard``)
    and the grouping by relation ``rel_runs``, built on the host once.

    Pad edges keep ``mask == 0`` (weight-0 slots, as on a sampled block),
    but their endpoints are spread over the rows, pad ``j`` at destination
    ``j % rows_per_shard`` and halo row ``j % h_cap``, where the partition
    puts them all at 0: a shard with 441,598 pads (the smaller of two at
    full width) would otherwise give row 0 a run of that many slots, which
    one group of lanes walks alone. Every pad comes after the shard's real
    edges, so a real row's run holds its real edges first, in their
    order, and then at most pads whose terms are zero: each real row sums
    the same values in the same order as the single-device graph does."""
    from repro_torch.kernels.backend import resolve_device

    dev = resolve_device(device)
    k = int((part.perm[s] < part.n_edges).sum())
    src = part.src_h[s].astype(np.int64)
    dst = part.dst_l[s].astype(np.int64)
    j = np.arange(part.e_cap - k)
    src[k:] = j % part.h_cap
    dst[k:] = j % part.rows_per_shard
    layout = build_spmm_layout(src, dst, n_dst=part.rows_per_shard,
                               n_src=part.h_cap, block_e=block_e,
                               block_rows=block_rows, device=dev)

    def t(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    return {"src": t(src), "dst": t(dst), "rel": t(part.rel[s]),
            "mask": t(part.mask[s], np.float32), "layout": layout,
            "rel_runs": relation_runs(part.rel[s], n_relations, device=dev),
            "halo": t(part.halo[s]), "halo_count": int(part.halo_count[s]),
            "n_real": k}


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Host-side geometry of a dim-0 row-sharded table over the ``model``
    ranks (port of ``repro/data/csr.py:RowPartition``): global row ``i``
    lives on shard ``i // rows_per_shard`` at local offset
    ``i % rows_per_shard``; rows ``>= n_rows`` are padding (zero, and zero
    gradient)."""

    n_rows: int          # real rows (e.g. n_nodes)
    n_shards: int        # model-axis extent
    rows_per_shard: int  # block rows per shard (includes padding)

    @property
    def n_rows_padded(self) -> int:
        return self.n_shards * self.rows_per_shard

    def owner_of(self, ids):
        return np.asarray(ids) // self.rows_per_shard

    def local_of(self, ids):
        ids = np.asarray(ids)
        return ids - self.owner_of(ids) * self.rows_per_shard

    def pad_table(self, table):
        """Zero-pad a host ``(n_rows, ...)`` table to ``n_rows_padded``."""
        table = np.asarray(table)
        if table.shape[0] != self.n_rows:
            raise ValueError(
                f"table has {table.shape[0]} rows, partition built for "
                f"{self.n_rows}")
        pad = [(0, self.n_rows_padded - self.n_rows)]
        pad += [(0, 0)] * (table.ndim - 1)
        return np.pad(table, pad)

    def blocks(self, table):
        """Padded table reshaped ``(n_shards, rows_per_shard, ...)``."""
        padded = self.pad_table(table)
        return padded.reshape(
            self.n_shards, self.rows_per_shard, *padded.shape[1:])


def row_partition(n_rows: int, n_shards: int, *, pad_to: int | None = None):
    """Split ``n_rows`` table rows evenly over ``n_shards`` ranks;
    ``pad_to`` widens the addressable row space first (the 2D mesh passes
    the edge partition's ``n_nodes_padded``, so every data shard's
    destination rows have an owner)."""
    if n_rows < 1 or n_shards < 1:
        raise ValueError(
            f"row_partition needs n_rows >= 1 and n_shards >= 1, got "
            f"{n_rows} rows over {n_shards} shards")
    span = max(int(n_rows), int(pad_to or 0))
    return RowPartition(
        n_rows=int(n_rows), n_shards=int(n_shards),
        rows_per_shard=-(-span // int(n_shards)))
