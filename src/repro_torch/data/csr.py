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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["CSRMeta", "SpmmLayout", "Direction", "SegmentRuns",
           "static_block_caps", "build_spmm_layout", "relation_runs",
           "attach_layout", "map_tensors", "to_device", "stable_argsort",
           "group_ids"]

REL_CHUNK = 256   # slots a relation chunk holds (relation_runs)


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
class SegmentRuns:
    """One level of a fixed-order segment sum over ``n_rows`` input rows:
    output row ``r`` is the sum of input rows ``perm[s]`` for slots
    ``row_start[r] <= s < row_end[r]``, in slot order. A grouping is a tuple
    of levels, each summing the previous level's output."""

    perm: torch.Tensor        # (n_slots,) int32 input row of each slot
    row_start: torch.Tensor   # (n_out,) int32
    row_end: torch.Tensor     # (n_out,) int32
    n_out: int
    n_rows: int


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
                            dr.row_end, dr.n_out, self.meta.n_edges),)


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
    ``fn`` applied to every tensor."""
    if isinstance(obj, tuple):
        return tuple(map_tensors(o, fn) for o in obj)
    return dataclasses.replace(obj, **{
        f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


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
        meta=meta)


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

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    levels = []
    while True:
        start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        if counts.max(initial=0) <= chunk:
            levels.append(SegmentRuns(t(perm), t(start), t(start + counts),
                                      n_relations, n_rows))
            return tuple(levels)
        # cut every run into chunks of `chunk` slots; the next level sums
        # each relation's chunks, in order
        n_ch = -(-counts // chunk)
        owner = np.repeat(np.arange(n_relations), n_ch)
        first = np.concatenate([[0], np.cumsum(n_ch)[:-1]])
        c0 = start[owner] + (np.arange(int(n_ch.sum())) - first[owner]) * chunk
        c1 = np.minimum(c0 + chunk, (start + counts)[owner])
        levels.append(SegmentRuns(t(perm), t(c0), t(c1), len(c0), n_rows))
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
