"""Collectives of the multi-rank path over ``torch.distributed`` (no
counterpart module in the reference, which calls ``jax.lax`` inside
``shard_map``).

``TorchMesh`` is the ranks' mesh: a ``MeshSpec`` (``sharding.mesh_spec``),
this rank's coordinates (rank ``r`` sits at the row-major coordinates of
``r`` in the spec's shape) and, for every non-empty set of axes, the
process subgroup of the ranks that differ only along those axes. The
collectives take the mesh and one axis name or a tuple of them, as
``jax.lax`` does:

  * ``all_gather(x, mesh, axis, dim)``: the tiled all-gather, an autograd
    ``Function`` whose backward is ``psum_scatter`` of the cotangent (JAX's
    transpose: each rank gets the sum of every rank's cotangent for its
    own slice);
  * ``psum_scatter(x, mesh, axes, dim)``: sum over the ranks, each keeps
    its slice;
  * ``psum`` and ``pmax``: all-reduce by sum and by max (no gradient: the
    step differentiates through them only inside ``sharding.rowshard``,
    whose functions carry their own backward).

One route moves the data on every backend (``ROUTE``, printed on the
launcher's and ``chip_smoke.py``'s ``[dp]`` lines): ``allreduce``. Gloo,
which ranks sharing one card or running on the CPU use, takes only
``broadcast`` and ``all_reduce`` on CUDA tensors, so the all-gather is an
``all_reduce`` sum of a zero-filled buffer in which each rank has written
its slice (exact: each element is one value plus zeros), and the
reduce-scatter an ``all_reduce`` sum of the whole buffer of which each rank
keeps its slice (the same sums). NCCL, chosen when every rank has a card
of its own (``launch.mesh.rank_device``), takes the same route: its
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` wait for a
machine with several cards to be tested on. CPU tensors on gloo take the
same route too, so the CPU tests run what the card runs.

Each collective is reported to ``obs.cost`` by its kind as the reference's
HLO names it (``all_gather``: "all-gather" of the gathered bytes;
``psum_scatter``: "reduce-scatter" of the slice; ``psum``/``pmax``:
"all-reduce") and the ranks of its axes, so that a traced step
(``launch.roofline.trace_step``) prices it with the reference's per-kind
model. The ``allreduce`` route moves more than that model's all-gather and
reduce-scatter on the wire.

Every element of a result is the same bits on every rank (the ring
all-reduce reduces each chunk once and broadcasts it), and all compute
stays where the tensors are: this is a transport, not a fallback.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.distributed as dist

from repro_torch.obs import cost

ROUTE = "allreduce"     # how every collective travels; module docstring

__all__ = ["ROUTE", "TorchMesh", "all_gather", "psum_scatter", "psum", "pmax",
           "gather_rows_of_ranks", "digest"]


@dataclasses.dataclass
class TorchMesh:
    """The ranks' mesh; see module docstring."""

    spec: object                 # MeshSpec
    rank: int
    coords: dict                 # axis name -> this rank's index
    groups: dict                 # axes tuple -> this rank's ProcessGroup
    backend: str
    device: torch.device | None = None

    @classmethod
    def build(cls, spec, *, device=None) -> "TorchMesh":
        """Make every subgroup of ``spec`` on the initialized default group
        (every rank must call this, in the same order)."""
        if not dist.is_initialized():
            raise RuntimeError(
                f"mesh {spec} needs torch.distributed initialized (start "
                f"the ranks with repro_torch.launch.mesh.run_ranks or "
                f"torchrun)")
        world = dist.get_world_size()
        if world != spec.size:
            raise RuntimeError(
                f"mesh {spec} has {spec.size} ranks but the process group "
                f"has {world}; start {spec.size} ranks (torchrun "
                f"--nproc-per-node {spec.size}) or change --mesh")
        rank = dist.get_rank()
        names, shape = spec.names, spec.shape
        grid = list(itertools.product(*(range(e) for e in shape)))
        coords = dict(zip(names, grid[rank]))
        groups = {}
        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(names, k):
                if len(sub) == len(names):
                    groups[sub] = dist.group.WORLD
                    continue
                others = [n for n in names if n not in sub]
                fixed = sorted({tuple(c[names.index(n)] for n in others)
                                for c in grid})
                for f in fixed:
                    ranks = [r for r, c in enumerate(grid)
                             if tuple(c[names.index(n)] for n in others) == f]
                    grp = dist.new_group(ranks)
                    if rank in ranks:
                        groups[sub] = grp
        return cls(spec=spec, rank=rank, coords=coords, groups=groups,
                   backend=str(dist.get_backend()), device=device)

    # -- the jax.sharding.Mesh face MeshSpec.check_mesh reads -------------

    @property
    def axis_names(self) -> tuple:
        return self.spec.names

    @property
    def shape(self) -> dict:
        return dict(self.spec.axes)

    # -- coordinates -------------------------------------------------------

    def axes(self, axes) -> tuple:
        """``axes`` as a tuple in the mesh's order, every name checked."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.coords:
                raise ValueError(f"mesh {self.spec} has no axis {a!r}")
        return tuple(a for a in self.spec.names if a in axes)

    def size(self, axes) -> int:
        n = 1
        for a in self.axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's row-major index among the ranks of ``axes``."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        return self.groups[self.axes(axes)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _all_reduce(t: torch.Tensor, mesh: TorchMesh, axes, op) -> torch.Tensor:
    n = mesh.size(axes)
    if n > 1:
        cost.collective("all-reduce", _nbytes(t), n)
        dist.all_reduce(t, op=op, group=mesh.group(axes))
    return t


def psum(x: torch.Tensor, mesh: TorchMesh, axes) -> torch.Tensor:
    """Sum over the ranks of ``axes`` (a new tensor; no gradient)."""
    return _all_reduce(x.detach().clone().contiguous(), mesh, axes,
                       dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh: TorchMesh, axes) -> torch.Tensor:
    """Elementwise max over the ranks of ``axes`` (no gradient)."""
    return _all_reduce(x.detach().clone().contiguous(), mesh, axes,
                       dist.ReduceOp.MAX)


def _gather(x: torch.Tensor, mesh: TorchMesh, axes, dim: int):
    n = mesh.size(axes)
    if n == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    rows = xm.shape[0]
    out = xm.new_zeros((n * rows,) + xm.shape[1:])
    i = mesh.index(axes)
    out[i * rows:(i + 1) * rows] = xm
    cost.collective("all-gather", _nbytes(out), n)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group(axes))
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, mesh: TorchMesh, axes, dim: int):
    n = mesh.size(axes)
    if n == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"psum_scatter of {xm.shape[0]} rows over {n} "
                         f"ranks")
    rows = xm.shape[0] // n
    cost.collective("reduce-scatter", _nbytes(xm) // n, n)
    dist.all_reduce(xm, op=dist.ReduceOp.SUM, group=mesh.group(axes))
    i = mesh.index(axes)
    return xm[i * rows:(i + 1) * rows].movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, mesh, axes, dim):
        fctx.mesh, fctx.axes, fctx.dim = mesh, axes, dim
        return _gather(x.detach(), mesh, axes, dim)

    @staticmethod
    def backward(fctx, g):
        return _scatter(g.clone(), fctx.mesh, fctx.axes, fctx.dim), \
            None, None, None


def all_gather(x: torch.Tensor, mesh: TorchMesh, axes, dim: int = 0):
    """The tiled all-gather along ``dim`` (rank ``i``'s slice at
    ``[i * rows, (i + 1) * rows)``); backward ``psum_scatter``."""
    return _AllGather.apply(x, mesh, axes, dim)


def psum_scatter(x: torch.Tensor, mesh: TorchMesh, axes, dim: int = 0):
    """Sum over the ranks of ``axes``; each keeps its tiled slice along
    ``dim`` (no gradient)."""
    return _scatter(x.detach().clone(), mesh, axes, dim)


def gather_rows_of_ranks(x: torch.Tensor, mesh: TorchMesh, axes):
    """``(n_ranks, ...)``: every rank's ``x`` stacked by rank index (small
    tensors: digests, counts)."""
    return _gather(x.detach()[None], mesh, axes, 0)


def digest(t: torch.Tensor) -> torch.Tensor:
    """A 64-bit fingerprint of a tensor's bits (0-d int64, on its device):
    equal tensors give equal digests, and a changed bit changes it."""
    bits = t.detach().contiguous().reshape(-1).view(torch.int32).long()
    w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return (bits * w).sum() + bits.numel()
