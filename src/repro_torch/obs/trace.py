"""Host-side span tracer with Chrome-trace / Perfetto JSON export (port of
``repro/obs/trace.py``).

The tracer answers "where did the step's wall-clock go" at the *host*
level — data fetch, device dispatch, host gather/scatter in the tiered
store, serving batch drains — the seams the device profiler cannot see.
Spans are plain ``(name, ts, dur, tid)`` complete events ("ph": "X"),
so the export loads directly in Perfetto / chrome://tracing and nests
by timestamp containment per thread.

Design constraints (DESIGN.md §13):

  * **near-zero overhead when disabled** — ``span()`` on a disabled
    tracer is one attribute check plus returning a shared no-op context
    manager (no allocation, no clock read).
  * **thread-aware** — events carry ``tid`` (``threading.get_ident``),
    so the prefetch producer, the serving worker and the main loop land
    on separate tracks.
  * **device bracket** — ``step_span`` additionally enters
    ``torch.profiler.record_function``, so a simultaneously captured
    ``torch.profiler`` trace aligns its steps with the host spans (a
    no-op when no profiler is collecting).

Span names reuse the ACT scope grammar (``/``-joined path components,
e.g. ``train/step/gather`` — see DESIGN.md §6, §13).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time

__all__ = ["Tracer", "get_tracer", "enable", "disable", "span", "traced",
           "step_span", "save"]


class _NullSpan:
    """Shared do-nothing context manager — the disabled fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


class _Span:
    """One live span: clock read on enter, event append on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        tr = self._tracer
        ev = {"name": self._name, "ph": "X", "cat": "host",
              "ts": (self._t0 - tr._epoch) * 1e6,
              "dur": (t1 - self._t0) * 1e6,
              "pid": tr._pid, "tid": threading.get_ident()}
        if self._args:
            ev["args"] = self._args
        with tr._lock:
            tr._events.append(ev)
        return False


class Tracer:
    """Collects host spans; exports the Chrome-trace event list.

    One tracer instance is process-global (``get_tracer()``); tests may
    build private instances. ``enabled`` is the only state the hot path
    reads.
    """

    def __init__(self):
        self.enabled = False
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._epoch = time.perf_counter()

    # -- lifecycle ----------------------------------------------------------

    def enable(self) -> "Tracer":
        """Start (or restart) collection; clears prior events."""
        with self._lock:
            self._events = []
            self._epoch = time.perf_counter()
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    # -- spans --------------------------------------------------------------

    def span(self, name: str, **args):
        """Context manager timing the enclosed block as one complete
        event. Returns a shared no-op when disabled."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, args or None)

    def step_span(self, name: str, step: int):
        """A per-step span that also brackets a ``torch.profiler``
        ``record_function`` range (aligns host and device timelines when a
        torch profile is being captured simultaneously)."""
        if not self.enabled:
            return _NULL
        from torch.profiler import record_function

        stack = contextlib.ExitStack()
        stack.enter_context(_Span(self, name, {"step": step}))
        stack.enter_context(record_function(f"{name}#{step}"))
        return stack

    # -- export -------------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome_trace(self, *, run: dict | None = None) -> dict:
        """The Perfetto/chrome://tracing JSON object."""
        return {"traceEvents": self.events(),
                "displayTimeUnit": "ms",
                "metadata": {"tracer": "repro_torch.obs.trace",
                             **(run or {})}}

    def save(self, path: str, *, run: dict | None = None) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(run=run), f)
        return path


# -- module-level convenience over the process tracer -----------------------

_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enable() -> Tracer:
    return _TRACER.enable()


def disable() -> Tracer:
    return _TRACER.disable()


def span(name: str, **args):
    return _TRACER.span(name, **args)


def step_span(name: str, step: int):
    return _TRACER.step_span(name, step)


def save(path: str, *, run: dict | None = None) -> str:
    return _TRACER.save(path, run=run)


def traced(fn_or_name=None):
    """Decorator form: ``@traced`` or ``@traced("serve/score")``.

    Disabled tracing costs one bool check per call — safe on warm paths.
    """
    def deco(fn, label=None):
        label = label or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _TRACER.enabled:
                return fn(*a, **kw)
            with _TRACER.span(label):
                return fn(*a, **kw)
        return wrapper

    if callable(fn_or_name):
        return deco(fn_or_name)
    return lambda fn: deco(fn, fn_or_name)
