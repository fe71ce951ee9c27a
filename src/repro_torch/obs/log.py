"""Leveled stderr logging for progress lines (a copy of
``repro/obs/log.py``).

Benchmarks and launchers print machine-parseable result lines on
stdout; everything narrative ("[trainer] step 50: ...") goes through
``log(msg, level)`` to **stderr**, filtered by ``REPRO_LOG_LEVEL``
(debug | info | warning | error, default info). ``set_log_level``
overrides the environment for the process (tests, notebooks).

Deliberately not the stdlib ``logging`` module: no handler graph, no
global config mutation on import, one function — the call sites here
were bare ``print``s and need exactly one step up from that.
"""

from __future__ import annotations

import os
import sys

__all__ = ["log", "set_log_level", "log_level"]

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

_OVERRIDE: str | None = None


def set_log_level(level: str | None) -> None:
    """Process-wide override; ``None`` returns control to the env var."""
    global _OVERRIDE
    if level is not None and level not in LEVELS:
        raise ValueError(f"unknown log level {level!r} "
                         f"(have {sorted(LEVELS)})")
    _OVERRIDE = level


def log_level() -> str:
    """Effective level: ``set_log_level`` beats ``REPRO_LOG_LEVEL``."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    env = os.environ.get("REPRO_LOG_LEVEL", "info").lower()
    return env if env in LEVELS else "info"


def log(msg: str, level: str = "info") -> None:
    """Print ``msg`` to stderr iff ``level`` clears the threshold."""
    if LEVELS.get(level, 20) >= LEVELS[log_level()]:
        print(msg, file=sys.stderr, flush=True)
