"""Measured tile selection for the hand-written kernels, with an on-disk
cache (port of ``repro/kernels/autotune.py``).

  * a **key** is ``(op, shape-bucket, bits, extra)``: shapes are bucketed
    to the next power of two, so one sweep serves a family of nearby shapes;
  * winners live in a JSON cache under the **device fingerprint**
    (``backend.DeviceInfo.fingerprint``: the card's name and capability,
    the CUDA runtime, the torch version and a hash of the kernel sources),
    so a choice measured on one card, toolchain or kernel version is never
    read on another;
  * ``pick()`` returns the cached winner, or the caller's default; it
    sweeps only when sweeping is enabled (``sweep=True`` /
    ``REPRO_AUTOTUNE=1``) and the caller passes a ``measure`` callable over
    concrete inputs. A sweep takes each candidate's device time: CUDA
    events around calls queued behind a stream held by a spinning kernel,
    after a warm-up call. A candidate that fails raises: a CUDA fault is
    sticky, and the callers' candidate sets are valid by construction.

Cache format (versioned, one file, rewritten atomically):

    {"version": 1,
     "<fingerprint>": {
        "<key>": {"winner": {...params}, "us": {...per-candidate}}}}

The same fingerprint and key never re-sweep: a second process loading the
file returns the stored winner with no measurement (``n_sweeps`` stays 0).

The top-K and coarse wrappers (``kernels.topk_score``) pick their query
tile here (8, 16 or 32; default 0, the planner's choice by B). Every tile
gives the same bits, so the cache changes times, never results. The
dequant-matmul's chunk count is not tuned: it regroups the kernel's
fixed-order sum, so its bits would depend on the cache. Nor is the
quant-pack's stage size: it is a compile-time constant of its kernel.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Callable, Sequence

__all__ = ["Autotuner", "get", "reset", "shape_bucket", "DEFAULT_CACHE_PATH",
           "QUERY_TILES"]

DEFAULT_CACHE_PATH = os.environ.get(
    "REPRO_TORCH_AUTOTUNE_CACHE",
    str(Path(__file__).resolve().parents[3] / "artifacts"
        / "autotune_cache_torch.json"))

_CACHE_VERSION = 1
QUERY_TILES = (8, 16, 32)      # csrc/topk_select.cuh kQTiles


def shape_bucket(n: int) -> int:
    """Next power of two >= n (1 for n <= 1): the shape-family key."""
    if n <= 1:
        return 1
    return 1 << (int(n - 1)).bit_length()


def _sweep_enabled_default() -> bool:
    return os.environ.get("REPRO_AUTOTUNE", "0") == "1"


_HOLD_CYCLES = int(2e7)        # about 10 ms of the card's clock


def _device_ms(fn: Callable[[], None], reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after a warm-up: a
    spinning kernel holds the stream while the host queues the calls, so
    they run back to back between two CUDA events (a host-paced timing
    would read the launches' Python overhead, not the candidates)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_HOLD_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


class Autotuner:
    """Measured tile selection with an on-disk, fingerprint-keyed cache."""

    def __init__(self, path: str | None = None, *,
                 sweep: bool | None = None,
                 fingerprint: str | None = None,
                 reps: int = 10):
        from . import backend

        self.path = DEFAULT_CACHE_PATH if path is None else path
        self.sweep = _sweep_enabled_default() if sweep is None else sweep
        self.fingerprint = fingerprint or backend.probe().fingerprint
        self.reps = reps
        self.n_sweeps = 0          # candidates measured (test observable)
        # callers' memo of pick's answers by exact call shape: an answer
        # never changes once given (sweeping or not is fixed per instance,
        # and a sweep stores its key's winner before it returns)
        self.picked: dict = {}
        self._cache = self._load()

    # -- persistence ------------------------------------------------------

    def _load(self) -> dict:
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    data = json.load(f)
                if data.get("version") == _CACHE_VERSION:
                    return data
            except (OSError, ValueError):
                pass
        return {"version": _CACHE_VERSION}

    def _save(self) -> None:
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".",
                                   suffix=".autotune")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._cache, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            if os.path.exists(tmp):
                os.unlink(tmp)

    # -- keys -------------------------------------------------------------

    @staticmethod
    def key(op: str, shapes: Sequence[int], *, bits: int | None = None,
            extra: str = "") -> str:
        dims = "x".join(str(shape_bucket(int(s))) for s in shapes)
        parts = [op, dims]
        if bits is not None:
            parts.append(f"b{bits}")
        if extra:
            parts.append(extra)
        return "|".join(parts)

    # -- selection --------------------------------------------------------

    def lookup(self, key: str) -> dict | None:
        entry = self._cache.get(self.fingerprint, {}).get(key)
        return dict(entry["winner"]) if entry else None

    def timings(self, key: str) -> dict:
        """The stored device µs of each candidate of ``key`` ({} if none)."""
        entry = self._cache.get(self.fingerprint, {}).get(key)
        return dict(entry["us"]) if entry else {}

    def pick(self, op: str, *, shapes: Sequence[int],
             bits: int | None = None, extra: str = "",
             candidates: Sequence[dict] = (),
             measure: Callable[[dict], None] | None = None,
             default: dict) -> dict:
        """Cached winner for (op, shape-bucket, bits, extra), else a sweep
        (enabled, with ``measure`` and candidates) or ``default``.

        ``measure(params)`` launches the op once with ``params`` on the
        current stream."""
        key = self.key(op, shapes, bits=bits, extra=extra)
        hit = self.lookup(key)
        if hit is not None:
            return hit
        if not (self.sweep and measure is not None and candidates):
            return dict(default)
        timings: dict[str, float] = {}
        best, best_us = dict(default), float("inf")
        for params in candidates:
            us = _device_ms(lambda p=params: measure(p), self.reps) * 1e3
            self.n_sweeps += 1
            timings[json.dumps(params, sort_keys=True)] = round(us, 3)
            if us < best_us:
                best, best_us = dict(params), us
        self._cache.setdefault(self.fingerprint, {})[key] = {
            "winner": best, "us": timings}
        self._save()
        return dict(best)


_singleton: Autotuner | None = None


def get() -> Autotuner:
    """Process-wide autotuner over the default cache path."""
    global _singleton
    if _singleton is None:
        _singleton = Autotuner()
    return _singleton


def reset(path: str | None = None, **kw) -> Autotuner | None:
    """Swap the process-wide autotuner (tests, benchmarks); with no
    arguments the next ``get()`` builds a fresh one."""
    global _singleton
    _singleton = Autotuner(path, **kw) if (path or kw) else None
    return _singleton
