"""What a traced step cannot see as aten ops: the work of the hand-written
kernels and the bytes of the collectives, reported where they are called.

``kernels.ops`` brackets every kernel call, on either route, in
``kernel(name, cost_fn, *shape_args)``; ``sharding.comm`` reports each
collective through ``collective(kind, nbytes, group)``. Nothing is computed
while no one listens. ``launch.roofline.trace_step`` listens
(``listen(counter)``): the counter gets the kernel's ``KernelCost`` (its
module's cost function of the call's shapes) and, inside the bracket, the
torch dispatch modes are set aside, so that neither the plain version's
aten ops (on the CPU) nor the wrapper's allocations (on the card) count a
second time.

This module imports neither torch nor numpy at module scope.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["listen", "listening", "kernel", "collective"]

_LISTENERS: list = []
_LOCK = threading.Lock()


def listening() -> bool:
    return bool(_LISTENERS)


@contextlib.contextmanager
def listen(listener):
    """Send every kernel and collective report to ``listener`` (its
    ``kernel(name, cost)`` and ``collective(kind, nbytes, group)``) for the
    block; reports come from any thread (the autograd engine's too)."""
    with _LOCK:
        _LISTENERS.append(listener)
    try:
        yield listener
    finally:
        with _LOCK:
            _LISTENERS.remove(listener)


_IDLE = contextlib.nullcontext()


def kernel(name: str, cost_fn, *args, **kw):
    """One call of the hand-written kernel ``name``: a context that reports
    ``cost_fn(*args, **kw)`` and runs the block with the dispatch modes set
    aside. While no one listens it is one shared no-op context, and
    ``cost_fn`` is not called."""
    if not _LISTENERS:
        return _IDLE
    return _reported(name, cost_fn, args, kw)


@contextlib.contextmanager
def _reported(name, cost_fn, args, kw):
    from torch.utils._python_dispatch import _disable_current_modes

    c = cost_fn(*args, **kw)
    for listener in list(_LISTENERS):
        listener.kernel(name, c)
    with _disable_current_modes():
        yield


def collective(kind: str, nbytes: int, group: int) -> None:
    """One collective of ``kind`` (the reference's HLO names: "all-reduce",
    "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
    whose result holds ``nbytes``, over ``group`` ranks."""
    for listener in list(_LISTENERS):
        listener.collective(kind, nbytes, group)
