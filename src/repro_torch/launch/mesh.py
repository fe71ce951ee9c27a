"""Rank start-up for the multi-rank path (port of ``repro/launch/mesh.py``,
which builds a device mesh in one process; here each rank is a process).

``run_ranks(fn, mesh_spec, device=..., args=...)`` runs
``fn(rank_runtime, *args)`` on every rank of the mesh and returns what each
returned, in rank order:

  * under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) it
    joins the process group torchrun set up and runs this rank's ``fn``
    alone (a list of one);
  * otherwise it spawns the mesh's ranks itself (``torch.multiprocessing``,
    the ``spawn`` start method), one process a rank, rendezvous at
    ``tcp://localhost:<a free port>``, and collects their results; a rank
    that raises makes ``run_ranks`` raise with that rank's traceback.

Devices and backends: on ``cuda`` rank ``r`` takes ``cuda:r`` when there
are at least as many cards as ranks, and then the backend is ``nccl``;
with fewer cards every rank takes ``cuda:0`` and the backend is ``gloo``
(NCCL refuses two ranks on one card). On the CPU the backend is ``gloo``.
Every backend's collectives take ``sharding.comm``'s one route. Without a card, ``cuda`` raises, as every entry point of the
port does. The ranks share the host's cores: each takes ``cores / ranks``
intra-op threads. Before spawning on ``cuda`` the launching process builds the
kernels once (``kernels.backend.build``), so the ranks do not race to
build them.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.sharding.mesh_spec import MeshSpec

__all__ = ["RankRuntime", "run_ranks", "under_torchrun", "rank_device"]


@dataclasses.dataclass
class RankRuntime:
    """What a rank's ``fn`` is given: its mesh (``sharding.comm.TorchMesh``),
    device and ranks."""

    mesh: object
    device: torch.device
    rank: int
    world_size: int
    local_rank: int

    @property
    def is_root(self) -> bool:
        return self.rank == 0


def under_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def rank_device(device: str, local_rank: int, world: int):
    """``(device, backend)`` of one rank; see module docstring."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu"), "gloo"
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is false; pass "
            "device='cpu' (--device cpu) to run the ranks on the CPU with "
            "gloo")
    n = torch.cuda.device_count()
    if n >= world:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", 0), "gloo"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init(spec: MeshSpec, device: str, rank: int, world: int,
          local_rank: int, init_method: str) -> RankRuntime:
    dev, backend = rank_device(device, local_rank, world)
    # the ranks share the host's cores: one rank's intra-op threads each
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return RankRuntime(mesh=spec.build_mesh(device=dev), device=dev,
                       rank=rank, world_size=world, local_rank=local_rank)


def _rank_main(rank, world, init_method, spec_str, device, fn, args, out):
    try:
        rt = _init(MeshSpec.parse(spec_str), device, rank, world, rank,
                   init_method)
        try:
            res = fn(rt, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", res))
    except BaseException:   # noqa: BLE001 (reported to the launcher)
        out.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, mesh_spec, *, device: str = "cuda", args: tuple = (),
              timeout_s: float = 3600.0) -> list:
    """Run ``fn(RankRuntime, *args)`` on every rank of ``mesh_spec``; see
    module docstring. ``fn`` must be importable by name (a module-level
    function) and return something picklable."""
    spec = MeshSpec.parse(mesh_spec)
    if under_torchrun():
        world = int(os.environ["WORLD_SIZE"])
        if world != spec.size:
            raise RuntimeError(
                f"--mesh {spec} needs {spec.size} ranks, torchrun started "
                f"{world}: run torchrun --nproc-per-node {spec.size}, or "
                f"drop torchrun and let the launcher spawn the ranks")
        rt = _init(spec, device, int(os.environ["RANK"]), world,
                   int(os.environ["LOCAL_RANK"]), "env://")
        try:
            return [fn(rt, *args)]
        finally:
            dist.destroy_process_group()
    rank_device(device, 0, spec.size)   # fail here, not in every rank
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import backend

        backend.build()
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init_method = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(
        r, spec.size, init_method, str(spec), device, fn, args, out),
        daemon=False) for r in range(spec.size)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) + len(errors) < spec.size:
            try:
                rank, status, res = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                if dead:
                    errors.update({r: f"rank {r} exited with code "
                                      f"{procs[r].exitcode}" for r in dead})
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks of {spec} did not finish in "
                                       f"{timeout_s:.0f} s")
                continue
            (results if status == "ok" else errors)[rank] = res
            if errors:
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        r = min(errors)
        raise RuntimeError(f"rank {r} of mesh {spec} failed:\n{errors[r]}")
    return [results[r] for r in range(spec.size)]
