"""Telemetry sinks: JSONL step log + schema-validated run summary (a copy
of ``repro/obs/sinks.py``: the same schema, so either package's validator
accepts the other's summaries).

Two artifacts per run (``--metrics-out DIR`` in the launchers):

  * ``steps.jsonl`` — one JSON object per step (``StepLogWriter``):
    append-only, crash-tolerant (every line flushed), the raw timeline
    that p99 analyses and the activation-bytes timeline read.
  * ``summary.json`` — the end-of-run registry snapshot plus run
    identity, validated against ``SUMMARY_SCHEMA`` **before** it is
    written: a malformed summary fails the producing run, not the job
    that consumes it later.
"""

from __future__ import annotations

import json
import os
from typing import IO

__all__ = ["SCHEMA_VERSION", "SUMMARY_SCHEMA", "SummarySchemaError",
           "validate_summary", "build_summary", "write_summary",
           "StepLogWriter"]

SCHEMA_VERSION = 1

_HIST_KEYS = ("count", "sum", "min", "max", "p50", "p95", "p99")

# Declarative top-level shape (documentation + the validator's source of
# truth): section -> required type. ``run`` must carry a string ``kind``
# ("train" | "serve" | "bench" | ...); metric sections map series keys
# (``name`` or ``name{label=v,...}``) to numbers / histogram dicts.
SUMMARY_SCHEMA = {
    "schema_version": int,
    "run": dict,
    "counters": dict,
    "gauges": dict,
    "histograms": dict,
}


class SummarySchemaError(ValueError):
    """A summary violated SUMMARY_SCHEMA; message lists every problem."""


def validate_summary(obj) -> None:
    """Raise ``SummarySchemaError`` naming ALL violations, or return.

    Pure-python structural validation (no jsonschema dependency in the
    container): required keys, section types, numeric metric values,
    histogram field completeness.
    """
    problems: list[str] = []
    if not isinstance(obj, dict):
        raise SummarySchemaError(
            f"summary must be a JSON object, got {type(obj).__name__}")
    for key, typ in SUMMARY_SCHEMA.items():
        if key not in obj:
            problems.append(f"missing required key {key!r}")
        elif not isinstance(obj[key], typ):
            problems.append(f"{key!r} must be {typ.__name__}, got "
                            f"{type(obj[key]).__name__}")
    if isinstance(obj.get("schema_version"), int) and \
            obj["schema_version"] != SCHEMA_VERSION:
        problems.append(f"schema_version {obj['schema_version']} != "
                        f"supported {SCHEMA_VERSION}")
    run = obj.get("run")
    if isinstance(run, dict) and not isinstance(run.get("kind"), str):
        problems.append("run.kind must be a string "
                        "(e.g. 'train', 'serve', 'bench')")
    for section in ("counters", "gauges"):
        vals = obj.get(section)
        if isinstance(vals, dict):
            for k, v in vals.items():
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    problems.append(f"{section}[{k!r}] must be a number, "
                                    f"got {type(v).__name__}")
    hists = obj.get("histograms")
    if isinstance(hists, dict):
        for k, h in hists.items():
            if not isinstance(h, dict):
                problems.append(f"histograms[{k!r}] must be an object")
                continue
            missing = [f for f in _HIST_KEYS if f not in h]
            if missing:
                problems.append(f"histograms[{k!r}] missing {missing}")
    if problems:
        raise SummarySchemaError(
            "summary schema violations: " + "; ".join(problems))


def build_summary(run: dict, registry=None, *, extra: dict | None = None):
    """Assemble (and validate) the summary object for ``run``.

    ``run`` is free-form identity (arch, schedule, mesh, argv, ...) but
    must carry ``kind``. ``registry`` defaults to the process registry.
    ``extra`` top-level keys are merged last (e.g. a bench's own rows).
    """
    from .metrics import get_registry

    reg = registry if registry is not None else get_registry()
    summary = {"schema_version": SCHEMA_VERSION, "run": dict(run),
               **reg.snapshot()}
    if extra:
        summary.update(extra)
    validate_summary(summary)
    return summary


def write_summary(out_dir: str, run: dict, registry=None, *,
                  extra: dict | None = None,
                  filename: str = "summary.json") -> str:
    """Validate then write ``<out_dir>/<filename>``; returns the path."""
    summary = build_summary(run, registry, extra=extra)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    return path


class StepLogWriter:
    """Append-only JSONL step log; every record flushed on write.

    ``extras`` is a dict merged into every record — the launcher parks
    per-run constants there (e.g. the traced activation-bytes total) so
    each step line is self-describing and the file reads as a timeline
    without a join against the summary.
    """

    def __init__(self, path: str):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self.extras: dict = {}
        self._f: IO | None = open(path, "w")
        self.n_records = 0

    def write(self, record: dict) -> None:
        if self._f is None:
            raise ValueError(f"StepLogWriter({self.path}) is closed")
        self._f.write(json.dumps({**self.extras, **record}) + "\n")
        self._f.flush()
        self.n_records += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "StepLogWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
