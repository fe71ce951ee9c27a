"""Render the dry-run records and a run's telemetry as markdown tables (port
of ``repro/launch/report.py``).

  PYTHONPATH=src python -m repro_torch.launch.report \\
      [--dryrun artifacts/dryrun_torch] [--metrics OUT/summary.json]

The tables are the reference's: ``dryrun_table`` (every record, ``ok`` or
not), ``roofline_table`` (the ``ok`` records of one mesh: the port prices
mesh ``"1"``, one card, where the reference renders 16x16 and 2x16x16) and
``metrics_table`` (a ``summary.json`` of ``--metrics-out``, validated by
``obs.validate_summary`` first). The dry-run table's "compile" column is
the port's ``first_step_s`` (the first step, the kernels built at first
use included); a peak that was not measured (a CPU record) prints "-".
The report goes to ``artifacts/report_torch.md``; the reference's
``artifacts/report.md`` is never written.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from pathlib import Path

from repro_torch.launch.dryrun import DEFAULT_OUT

__all__ = ["load_dir", "fmt_s", "roofline_table", "metrics_table",
           "dryrun_table", "main", "DEFAULT_REPORT"]

DEFAULT_REPORT = str(Path(__file__).resolve().parents[3] / "artifacts"
                     / "report_torch.md")


def load_dir(d: str) -> dict:
    out = {}
    for p in glob.glob(os.path.join(d, "*.json")):
        with open(p) as f:
            r = json.load(f)
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x*1e3:.2f}ms"


def _gb(x) -> str:
    return "-" if x is None else f"{x:.2f}"


def roofline_table(recs: dict, mesh: str) -> list[str]:
    lines = [
        "| arch | shape | compute | memory | collective | bottleneck | "
        "peak GB/dev | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, m), r in sorted(recs.items()):
        if m != mesh or not r.get("ok"):
            continue
        rf = r["roofline"]
        mem = r["memory"]["peak_gb"]
        frac = rf.get("roofline_fraction")
        lines.append(
            f"| {arch} | {shape} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
            f"{rf['dominant'].replace('_s','')} | {_gb(mem)} | "
            f"{'' if frac is None else f'{100*frac:.1f}%'} |")
    return lines


def metrics_table(summary: dict) -> list[str]:
    """Render a run's ``summary.json`` (``obs.sinks``) as markdown:
    counters and gauges one row each, histograms their count and
    p50/p95/p99."""
    run = summary.get("run", {})
    ident = " ".join(f"{k}={v}" for k, v in sorted(run.items())
                     if v is not None)
    lines = [f"run: `{ident}`" if ident else "run: `?`", "",
             "| metric | type | value | p50 | p95 | p99 |",
             "|---|---|---|---|---|---|"]
    for k, v in sorted(summary.get("counters", {}).items()):
        lines.append(f"| {k} | counter | {v:g} | - | - | - |")
    for k, v in sorted(summary.get("gauges", {}).items()):
        lines.append(f"| {k} | gauge | {v:g} | - | - | - |")
    for k, h in sorted(summary.get("histograms", {}).items()):
        lines.append(f"| {k} | histogram | n={h['count']} | "
                     f"{h['p50']:.3g} | {h['p95']:.3g} | {h['p99']:.3g} |")
    return lines


def dryrun_table(recs: dict) -> list[str]:
    lines = [
        "| arch | shape | mesh | compile | peak GB/dev | arg GB | status |",
        "|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, m), r in sorted(recs.items()):
        if r.get("ok"):
            first = r.get("first_step_s", r.get("compile_s"))
            lines.append(
                f"| {arch} | {shape} | {m} | {first}s | "
                f"{_gb(r['memory']['peak_gb'])} | "
                f"{r['memory']['argument_gb']:.2f} | ok |")
        else:
            lines.append(f"| {arch} | {shape} | {m} | - | - | - | "
                         f"FAIL: {r.get('error','?')[:60]} |")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", default=DEFAULT_OUT,
                    help="directory of dry-run records (launch.dryrun)")
    ap.add_argument("--out", default=DEFAULT_REPORT)
    ap.add_argument("--metrics", default=None, metavar="SUMMARY.json",
                    help="also render a telemetry summary.json "
                         "(launch --metrics-out) as a metrics table")
    args = ap.parse_args(argv)
    recs = load_dir(args.dryrun)
    parts = ["## Dry-run (one card)\n"]
    parts += dryrun_table(recs)
    parts.append("\n## Roofline — one card (mesh 1)\n")
    parts += roofline_table(recs, "1")
    if args.metrics:
        from repro_torch.obs import validate_summary

        with open(args.metrics) as f:
            summary = json.load(f)
        validate_summary(summary)
        parts.append("\n## Run telemetry\n")
        parts += metrics_table(summary)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(parts) + "\n")
    print("wrote", args.out, f"({len(recs)} dry-run cells)")


if __name__ == "__main__":
    main()
