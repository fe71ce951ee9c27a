"""Training launcher (port of the single-device, full-graph path of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch kgat --steps 10 \\
      --bits 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch kgcn --steps 100 \\
      --schedule first_layer_int8_rest_int2 --ckpt CKPT --metrics-out OUT \\
      --trace OUT/trace.json

Full-graph KG training (``--arch kgat|kgcn|kgin``) with activation-compressed
training (ACT): the reference's defaults from ``models.registry.build_step``
(the small synthetic CKG, dim 32, 3 layers, batch 512, Adam at lr 3e-3),
parameters from seed 0 and rounding seeds from root seed 1. ``--schedule``
takes a ``PolicySchedule`` spec (preset, uniform bit-width, or ordered
``[kind:]glob=bits`` rules; see ``repro_torch.core.policy.parse_schedule``);
``--bits`` is the uniform fast path, 0 the FP32 baseline. On ``cuda`` (the
default; without a card it raises) every kernel of the path is a
hand-written CUDA kernel; ``--device cpu`` runs their plain versions.

The loop is the fault-tolerant ``Trainer``: a checkpoint every
``max(steps // 4, 10)`` steps and at the end under ``--ckpt`` (default: a
fresh temporary directory), restore of the latest one at start (a second
run on the same directory resumes; a checkpoint of another arch or schedule
is refused), rollback and replay on a failed step. ``--metrics-out DIR``
writes ``steps.jsonl`` (one line a step, each stamped with the ACT bytes of
the first step's residuals) and the schema-validated ``summary.json`` of
this run's series (``main`` empties the process's metrics registry first);
``--trace OUT.json`` a Chrome-trace/Perfetto JSON of the host spans.

``--sample fanout=F1,F2,...`` trains on neighbour-sampled minibatches
instead (``training.tiering.run_sampled_training``; one fanout per layer,
the hop next to the seeds first, so ``n_layers = len(fanouts)``) with the
entity table split into a hot tier on the card (``--hot-frac`` of the rows)
and the rest in pinned host memory; no full graph is built on the card.
On ``cuda`` it trains the arch's paper config (d 64) on the
Amazon-Book-sized zipf-skewed graph, on ``cpu`` the small synthetic CKG at
dim 32; BPR batch 256 unless ``--batch`` says otherwise. It prints the
reference's ``[train] done; loss ... hit-rate ... rows/step ... hot-tier
... MiB of ... MiB table`` line; ``--trace`` and ``--metrics-out``
(summary only) work as above; it takes no checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch kgat --bits 2 \\
      --sample fanout=15,10,5 --hot-frac 0.1 --steps 20

``train_kgnn`` is the same path as a function, so that a caller can drive
it at any size and for any KG model, R-GCN included (``chip_smoke.py`` runs
it at full width).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.core.memory import publish_activation_report
from repro_torch.core.policy import schedule_from_cli, schedule_label
from repro_torch.kernels.backend import LAUNCH_COUNTS, resolve_device
from repro_torch.models.registry import arch_of, archs, build_step, \
    model_config
from repro_torch.obs import StepLogWriter, get_tracer, log, \
    reset_registry, write_summary
from repro_torch.training.optimizer import adam
from repro_torch.training.step import make_train_step, step_metadata, \
    trainable
from repro_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["train_kgnn", "main"]

ROOT_SEED = 1     # the reference launcher's root key is PRNGKey(1)


def _measured(train_step, dev: torch.device, step_writer=None):
    """Wrap a train step to add its kernel launches and, on the card, its
    peak allocated device memory to the step's metrics. With a
    ``step_writer``, the first step's activation-bytes report is published
    (``act/*`` gauges) and its total stamped onto every step line."""

    def run(state, batch, i):
        before = dict(LAUNCH_COUNTS)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        state, metrics = train_step(state, batch, i)
        metrics["launches"] = {k: v - before.get(k, 0)
                               for k, v in LAUNCH_COUNTS.items()
                               if v - before.get(k, 0)}
        metrics["max_memory_allocated"] = (
            torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
        if step_writer is not None and \
                "act_total_bytes" not in step_writer.extras:
            publish_activation_report(metrics["act"])
            step_writer.extras["act_total_bytes"] = \
                metrics["act"]["total_bytes"]
        return state, metrics

    return run


def train_kgnn(cfg, ds, params, schedule, steps: int, *, batch: int = 1024,
               device="cuda", graph=None, log_every: int = 1, log=None,
               ckpt_dir: str | None = None, ckpt_every: int = 10,
               schedule_spec: str | None = None, step_writer=None) -> dict:
    """Train ``cfg.model`` (kgat, kgcn, kgin or rgcn) up to step ``steps``
    from a copy of ``params`` (the caller's stay as they were) under
    ``schedule``.

    With ``ckpt_dir`` the run restores the latest checkpoint there first
    (refusing one of another arch, model or ``schedule_spec``), saves every
    ``ckpt_every`` steps and at the end, and rolls back to the last one on a
    failed step; without it, nothing is saved. ``step_writer`` (an
    ``obs.StepLogWriter``) gets one line a step.

    Returns ``steps``: one record per step run (``step``, ``loss``,
    ``seconds``, ``launches`` by kernel, ``max_memory_allocated`` on the
    card, and ``act``, the activation-bytes report of its saved residuals),
    and ``params``, the trained parameters. ``graph`` reuses a CKG already
    built on ``device``.
    """
    dev = resolve_device(device)
    # R-GCN's checkpoints say arch "kgat", model "rgcn"
    step = build_step(arch_of(cfg.model), ds=ds, cfg=cfg, batch_size=batch, device=dev,
                      graph=graph)
    opt = adam(step.lr)
    p = trainable(params)
    train_step = _measured(make_train_step(step, opt, schedule=schedule,
                                           root_seed=ROOT_SEED), dev,
                           step_writer)
    trainer = Trainer(
        train_step, (p, opt.init(p)), step.batches(),
        TrainerConfig(total_steps=steps, log_every=log_every,
                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
        log_fn=log, ckpt_meta=step_metadata(step, schedule_spec),
        step_writer=step_writer,
        items_per_step=int(step.data["graph"].src.shape[0]),
    ).restore_if_available()
    params_out, _ = trainer.run()
    return {"steps": trainer.history, "params": params_out}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--bits", type=int, default=2, choices=[0, 1, 2, 4, 8],
                    help="uniform ACT bit-width; 0 = FP32 baseline")
    ap.add_argument("--schedule", default=None,
                    help="PolicySchedule spec (preset | intN/fp32 | "
                         "'[kind:]glob=bits,...'); overrides --bits")
    ap.add_argument("--batch", type=int, default=None,
                    help="BPR batch size (default 512; 256 with --sample)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the kernels; cpu their plain versions")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome-trace/Perfetto JSON of the run's "
                         "host spans (train/step/... nesting)")
    ap.add_argument("--metrics-out", default=None, metavar="DIR",
                    help="write steps.jsonl (per-step timeline) and the "
                         "schema-validated summary.json registry snapshot "
                         "under DIR")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory; a second run on it resumes "
                         "(default: a fresh temporary directory)")
    ap.add_argument("--sample", default=None, metavar="fanout=F1,F2,...",
                    help="neighbour-sampled minibatch training with hot/cold "
                         "entity tiering; one fanout per layer, the hop next "
                         "to the seeds first")
    ap.add_argument("--hot-frac", type=float, default=0.1,
                    help="--sample: share of the entity rows kept on the "
                         "card (ranked by in-degree, LFU-refreshed)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    reset_registry()   # the summary holds this run's series alone
    schedule = schedule_from_cli(args.schedule, args.bits)
    label = schedule_label(args.schedule, args.bits)
    if args.trace:
        get_tracer().enable()
    try:
        if args.sample:
            return _run_sampled(args, dev, schedule, label)
        res = _run(args, dev, schedule, label)
    finally:
        get_tracer().disable()
    if not res["steps"]:
        print(f"[train] done; nothing to run past step {args.steps}")
        return
    act = res["steps"][0]["act"]
    print(f"[train] activation footprint {act['total_bytes'] / 2**20:.3f} "
          f"MiB ({act['compression_ratio']:.1f}x vs fp32)")
    losses = [r["loss"] for r in res["steps"]]
    print(f"[train] done; loss {losses[0]:.4f} -> {losses[-1]:.4f}")


def _run_sampled(args, dev, schedule, label: str) -> None:
    """--sample: minibatch KG training through the tiered row store."""
    from repro_torch.configs.kgnn_paper import AMAZON_BOOK_ZIPF
    from repro_torch.data.minibatch import parse_fanouts
    from repro_torch.data.synthetic import gen_zipf_kg_dataset
    from repro_torch.training.tiering import run_sampled_training

    if args.ckpt:
        raise SystemExit("error: --sample takes no checkpoints (--ckpt)")
    try:
        fanouts = parse_fanouts(args.sample)
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    batch = args.batch or 256
    # the card trains at the paper's size, the CPU's plain versions small
    if dev.type == "cuda":
        ds = gen_zipf_kg_dataset(**AMAZON_BOOK_ZIPF)
        cfg = dataclasses.replace(model_config(args.arch),
                                  n_layers=len(fanouts))
        step = build_step(args.arch, ds=ds, cfg=cfg, batch_size=batch,
                          device=dev, device_graph=False)
    else:
        step = build_step(args.arch, batch_size=batch, device=dev,
                          n_layers=len(fanouts), device_graph=False)
    ds = step.data["dataset"]
    log(f"[train] sampled {args.arch} ({step.family}) fanouts={fanouts} "
        f"hot_frac={args.hot_frac} schedule={label} "
        f"({ds.n_nodes} nodes, {len(ds.src)} edges, d {step.cfg.dim}) "
        f"device={dev}")
    report, _, _ = run_sampled_training(
        step, fanouts=fanouts, steps=args.steps, batch_size=batch,
        hot_frac=args.hot_frac, schedule=schedule, root_seed=ROOT_SEED,
        log_fn=log)
    _finish_telemetry(args, {
        "kind": "train", "arch": args.arch, "family": step.family,
        "schedule": label, "steps": args.steps, "mesh": None,
        "sample": args.sample})
    print(f"[train] done; loss {report.losses[0]:.4f} -> "
          f"{report.losses[-1]:.4f}  hit-rate {report.hit_rate:.2%}  "
          f"rows/step {report.rows_transferred_per_step:.0f}  "
          f"hot-tier {report.store_device_bytes / 2**20:.2f} MiB of "
          f"{report.table_bytes / 2**20:.2f} MiB table")


def _run(args, dev, schedule, label: str) -> dict:
    step = build_step(args.arch, batch_size=args.batch or 512, device=dev)
    run = {"kind": "train", "arch": args.arch, "family": step.family,
           "schedule": label, "steps": args.steps, "mesh": None,
           "sample": None}
    params = step.init(0)
    n = sum(t.numel() for v in params.values()
            for t in (v if isinstance(v, list) else [v]))
    log(f"[train] {args.arch} ({step.family}) {n / 1e6:.2f}M params "
        f"schedule={label} device={dev}")
    step_writer = (StepLogWriter(os.path.join(args.metrics_out,
                                              "steps.jsonl"))
                   if args.metrics_out else None)
    try:
        res = train_kgnn(
            step.cfg, step.data["dataset"], params, schedule, args.steps,
            batch=args.batch or 512, device=dev, graph=step.data["graph"],
            log_every=max(args.steps // 8, 5),
            ckpt_dir=args.ckpt or tempfile.mkdtemp(prefix="repro_ckpt_"),
            ckpt_every=max(args.steps // 4, 10), schedule_spec=label,
            step_writer=step_writer)
    finally:
        if step_writer is not None:
            step_writer.close()
    _finish_telemetry(args, run)
    return res


def _finish_telemetry(args, run: dict) -> None:
    """End-of-run artifacts: the Perfetto trace and the summary."""
    if args.trace:
        log(f"[train] trace written to "
            f"{get_tracer().save(args.trace, run=run)}")
    if args.metrics_out:
        log(f"[train] metrics summary written to "
            f"{write_summary(args.metrics_out, run)}")


if __name__ == "__main__":
    main()
