"""Dry run: build each arch's training step on the card, run one step under
``launch.roofline.trace_step`` and record what it costs (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles every arch x shape x mesh cell to HLO
without running it. The port has no HLO: it builds the step that
``models.registry.build_step`` builds on the card (``TRAIN_SHAPES``: the
paper's Amazon-Book-sized CKG at batch 1,024 for the KG archs, each GCN
shape, the recsys configs at batch 4,096, the LMs at their published widths
with 2 layers, batch 2 x 4,096), runs one Adam step at ``--bits`` or
``--schedule`` and prices it on ``--hw``. On ``--device cpu`` every arch
builds the registry's reduced CPU step instead, whatever the shape. The
mesh is ``"1"``, one card: cells of several ranks wait for the partition
slice (``launch/partition.py``), and ``--mesh`` other than 1 is a failed
record with the reason.

Per cell the record holds the reference's keys, so that ``launch.report``
reads them: ``arch``, ``shape``, ``mesh``, ``bits``, ``schedule``,
``n_devices``; ``build_s`` (step, data, parameters and optimizer state)
and ``first_step_s`` (the kernels built at first use included) in place of
``lower_s`` and ``compile_s``; ``memory`` (``argument_gb``: parameters,
Adam's moments and the batch on the device; ``params_gb``: the
parameters alone; ``peak_gb``: the step's
``max_memory_allocated``, reset before it, ``None`` on the CPU;
``act_gb``: the ACT residual bytes as ``core.memory`` prices them);
``roofline`` (``roofline_terms``), ``kernels`` (calls, FLOPs and bytes of
each hand-written kernel), ``loss``, and ``ok`` / ``error`` /
``traceback``. A config the port refuses (``check_fits``, an arch that
does not fit) is a record with ``ok: false`` and the refusal's own words.
Records go to ``artifacts/dryrun_torch/<arch>__<shape>__1__b<bits>.json``;
the command exits 1 if any record is not ok.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch kgat --bits 2
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --hw host
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-12b \\
      --shape train_4k --schedule first_layer_int8_rest_int2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, get
from repro_torch.core.policy import schedule_from_cli
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.roofline import HW_PROFILES, get_hw, trace_step
from repro_torch.models import registry
from repro_torch.training.optimizer import adam
from repro_torch.training.step import make_train_step

__all__ = ["run_cell", "build_cell_step", "TRAIN_SHAPES", "DEFAULT_OUT",
           "main"]

DEFAULT_OUT = str(Path(__file__).resolve().parents[3] / "artifacts"
                  / "dryrun_torch")
ROOT_SEED = 1
# the training shapes the registry builds on the card, by family (the
# first is each family's default)
TRAIN_SHAPES = {
    "kgnn": ("paper_full",),
    "gnn": ("full_graph_sm", "ogb_products", "minibatch_lg", "molecule"),
    "recsys": ("train_batch",),
    "lm": ("train_4k",),
    "moe_lm": ("train_4k",),
}
_MULTI = ("the dry run prices one card (mesh 1); {arch} trains on several "
          "ranks through launch.train --mesh, and its multi-device cells "
          "wait for launch/partition.py (not ported)")


def build_cell_step(arch: str, shape: str, dev: torch.device, *,
                    row_cap: int | None = None, **step_kw):
    """The ``ModelStep`` of ``arch`` at training ``shape`` on ``dev``
    (module docstring); ``step_kw`` goes to ``build_step`` (a caller that
    has the KG dataset and its graph on the card passes ``ds``, ``cfg``
    and ``graph``)."""
    family = registry.family_of(arch)
    spec = get(arch)
    kind = spec.shape(shape).kind
    if shape not in TRAIN_SHAPES[family]:
        raise ValueError(f"the dry run prices training steps; {arch}'s "
                         f"shape {shape} is a {kind} shape (training "
                         f"shapes: {list(TRAIN_SHAPES[family])})")
    if dev.type == "cpu":
        return registry.build_step(arch, device=dev, **step_kw)
    if family == "kgnn":
        if "ds" not in step_kw:
            from repro_torch.configs.kgnn_paper import AMAZON_BOOK_CKG
            from repro_torch.data.synthetic import gen_kg_dataset

            step_kw["ds"] = gen_kg_dataset(**AMAZON_BOOK_CKG)
        step_kw.setdefault("cfg", registry.model_config(arch))
        step_kw.setdefault("batch_size", spec.shape(shape).p()["batch"])
    elif family == "gnn":
        step_kw.setdefault("shape", shape)
    elif family == "recsys":
        step_kw.setdefault("row_cap", row_cap)
    return registry.build_step(arch, device=dev, **step_kw)


def _tensor_bytes(obj, seen: set) -> int:
    """Bytes of the distinct tensors in ``obj`` (dicts, lists, tuples and
    dataclasses, as a batch carries its lookup plans)."""
    if isinstance(obj, torch.Tensor):
        if id(obj) in seen:
            return 0
        seen.add(id(obj))
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v, seen) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_tensor_bytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    return 0


def _tag(rec: dict) -> str:
    if rec["schedule"] is not None:
        suffix = "s" + re.sub(r"[^A-Za-z0-9._-]", "_", rec["schedule"])
    else:
        suffix = f"b{rec['bits']}"
    return f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{suffix}"


def run_cell(arch: str, shape: str | None = None, *, bits: int | None = 2,
             schedule: str | None = None, device="cuda", hw: str = "h100",
             mesh: str = "1", out_dir: str | None = DEFAULT_OUT,
             verbose: bool = True, row_cap: int | None = None,
             step_kw: dict | None = None) -> dict:
    """Build, run and price one cell (module docstring); returns its
    record and writes it under ``out_dir`` (None: not written)."""
    family = registry.family_of(arch)
    shape = shape or TRAIN_SHAPES[family][0]
    rec = {"arch": arch, "shape": shape, "mesh": str(mesh),
           # --schedule overrides --bits; never attribute a mixed-schedule
           # cell's numbers to a uniform bit-width in the artifact
           "bits": None if schedule is not None else bits,
           "schedule": schedule, "n_devices": 1, "hw": hw}
    t0 = time.time()
    try:
        if str(mesh) != "1":
            why = {"gnn": registry.GNN_DP_UNSUPPORTED,
                   "recsys": registry.RECSYS_DP_UNSUPPORTED,
                   "lm": registry.LM_DP_UNSUPPORTED,
                   "moe_lm": registry.LM_DP_UNSUPPORTED}.get(family)
            raise NotImplementedError(why or _MULTI.format(arch=arch))
        dev = resolve_device(device)
        rec["device"] = str(dev)
        sched = schedule_from_cli(schedule, bits)
        step = build_cell_step(arch, shape, dev, row_cap=row_cap,
                               **(step_kw or {}))
        params = step.init(0)
        opt = adam(step.lr)
        state = (params, opt.init(params))
        batch = next(step.batches())
        train_step = make_train_step(step, opt, schedule=sched,
                                     root_seed=ROOT_SEED)
        arg_bytes = _tensor_bytes([state, batch], set())
        param_bytes = _tensor_bytes(params, set())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        rec["build_s"] = round(time.time() - t0, 2)
        t1 = time.time()
        traced = trace_step(train_step, state, batch, 0, hw=hw)
        (_, metrics) = traced.out
        loss = float(metrics["loss"])
        peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else None)
        rec["first_step_s"] = round(time.time() - t1, 2)
        rec["memory"] = {"argument_gb": arg_bytes / 2**30,
                         "params_gb": param_bytes / 2**30, "peak_gb": peak,
                         "act_gb": metrics["act"]["total_bytes"] / 2**30}
        rec["roofline"] = traced.terms
        rec["kernels"] = traced.kernels
        rec["loss"] = loss
        if verbose:
            m, r = rec["memory"], rec["roofline"]
            peak_s = "-" if peak is None else f"{peak:.2f} GB"
            print(f"[dryrun] {arch}/{shape} mesh=1 bits={rec['bits']}"
                  f"{f' schedule={schedule}' if schedule else ''}: build "
                  f"{rec['build_s']}s first step {rec['first_step_s']}s | "
                  f"peak {peak_s} | args {m['argument_gb']:.2f} GB | act "
                  f"{m['act_gb'] * 2**10:.2f} MiB | compute "
                  f"{r['compute_s'] * 1e3:.2f}ms memory "
                  f"{r['memory_s'] * 1e3:.2f}ms collective "
                  f"{r['collective_s'] * 1e3:.2f}ms -> {r['dominant']}",
                  flush=True)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch}/{shape} FAILED: {rec['error']}",
                  flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, _tag(rec) + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=float)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS),
                    help="single arch id (default: every arch)")
    ap.add_argument("--shape", default=None,
                    help="training shape (default: the family's first of "
                         "TRAIN_SHAPES)")
    ap.add_argument("--bits", type=int, default=2, choices=[0, 1, 2, 4, 8],
                    help="ACT bit-width (0 = FP32 baseline)")
    ap.add_argument("--schedule", default=None,
                    help="PolicySchedule spec (preset | intN/fp32 | rules); "
                         "overrides --bits")
    ap.add_argument("--mesh", default="1",
                    help="only 1 (one card) is priced; anything else is a "
                         "failed record with the reason")
    ap.add_argument("--row-cap", type=int, default=None, metavar="N",
                    help="recsys: cap each embedding table at N rows")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu builds the registry's reduced CPU steps")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--hw", default="h100", choices=sorted(HW_PROFILES),
                    help="hardware profile for the roofline denominators")
    args = ap.parse_args(argv)
    hw = get_hw(args.hw)
    bits = args.bits if args.bits else None
    arch_names = [args.arch] if args.arch else sorted(ARCHS)
    results = []
    for an in arch_names:
        shapes = [args.shape] if args.shape else \
            [TRAIN_SHAPES[registry.family_of(an)][0]]
        for sn in shapes:
            results.append(run_cell(an, sn, bits=bits,
                                    schedule=args.schedule,
                                    device=args.device, hw=args.hw,
                                    mesh=args.mesh, out_dir=args.out,
                                    row_cap=args.row_cap))
            if args.device == "cuda":
                torch.cuda.empty_cache()
    ok = sum(r["ok"] for r in results)
    print(f"[dryrun] {ok}/{len(results)} cells ran "
          f"(hw {args.hw}: {hw['peak_flops'] / 1e12:.0f} TF/s, "
          f"{hw['hbm_bw'] / 1e9:.0f} GB/s HBM, {hw['ici_bw'] / 1e9:.0f} GB/s "
          f"link)")
    if ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
