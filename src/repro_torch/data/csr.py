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

The port adds, for each direction, the slot run of every output row:
``row_start[r] .. row_end[r]`` are the slots of row ``r``'s edges (empty
rows have ``row_start == row_end``). A tile's real slots are sorted by
destination and its pad slots come after them, so each run is contiguous
and holds no pad slot. The CUDA SPMM kernel gives each row a warp and finds
its slots through these two arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["CSRMeta", "SpmmLayout", "Direction", "build_spmm_layout",
           "attach_layout"]


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


def _build_direction(gather_ids: np.ndarray, out_ids: np.ndarray,
                     n_out: int, block_e: int, block_rows: int):
    """Slot arrays for one aggregation direction (into ``n_out`` rows)."""
    E = int(out_ids.shape[0])
    n_tiles = max(1, -(-n_out // block_rows))
    order = np.argsort(out_ids, kind="stable").astype(np.int64)
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
                      device="cuda") -> SpmmLayout:
    """One-time host-side preprocessing of a COO edge list; the arrays land
    on ``device``. (The JAX builder's ``pad_static`` block caps, which the
    sampled-minibatch path needs, come with that slice.)"""
    from repro_torch.kernels.backend import resolve_device

    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"bad edge list shapes {src.shape}/{dst.shape}")
    n_src = int(n_src if n_src is not None else n_dst)
    E = int(src.shape[0])
    (src_blk, dstg_blk, ldst_blk, perm_blk, tile_of_blk, row_start, row_end,
     n_blocks, n_tiles) = _build_direction(src, dst, n_dst,
                                           block_e, block_rows)
    (t_src_blk, _t_outg, t_ldst_blk, t_perm_blk, t_tile_of_blk, t_row_start,
     t_row_end, t_n_blocks, t_n_tiles) = _build_direction(
        dst, src, n_src, block_e, block_rows)
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


def attach_layout(g, *, block_e: int = 256, block_rows: int = 256):
    """A copy of a graph dataclass (``models.kgnn.CKG``) with its ``layout``
    built from its COO edge list, on the graph's device."""
    layout = build_spmm_layout(
        g.src.cpu().numpy(), g.dst.cpu().numpy(), n_dst=g.n_nodes,
        block_e=block_e, block_rows=block_rows, device=g.src.device)
    return dataclasses.replace(g, layout=layout)
