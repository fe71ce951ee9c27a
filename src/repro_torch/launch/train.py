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

``--arch gcn-cora`` trains the GCN's full-graph node classification
(``models.registry``: the reference's mean cross-entropy, Adam at lr
1e-2): on ``cuda`` the full config (1,433 features, 16 hidden, 7 classes,
2 layers) on the ``full_graph_sm`` shape (2,708 nodes), on ``cpu`` the
reduced config on 300 nodes, as the reference's step. ``--bits``,
``--schedule``, ``--steps``, ``--ckpt``, ``--metrics-out``, ``--trace``
and ``--device`` work as for the KG archs; ``--mesh`` and ``--sample`` exit
with the reference's reasons.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
      --bits 2 --steps 8

``--arch fm|wide-deep|dlrm-mlperf|xdeepfm`` trains the recsys model's CTR
step (``models.registry``: the reference's mean logistic loss, Adam at lr
1e-3, ``criteo_batches(seed=3)``): on ``cuda`` the full config at batch
4,096, on ``cpu`` the reduced config at batch 256, as the reference's
step (``--batch`` overrides). ``--row-cap N`` caps each embedding table at
N rows; DLRM's full table (187,767,399 rows x 128 x 4 B = 96.1 GB) does
not fit one card and is refused up front, naming its bytes. ``--mesh``
and ``--sample`` exit with the reference's reasons.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xdeepfm \\
      --bits 2 --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
      --bits 2 --steps 6 --row-cap 2097152

``--arch mistral-large-123b|codeqwen1.5-7b|stablelm-12b|moonshot-v1-16b-a3b|
grok-1-314b`` trains the LM's next-token cross entropy (``models.registry``:
Adam at lr 1e-3 on ``lm_batches(seed=0)``, the whole stack one ACT site,
``lm/block``, recomputed in the backward from each block's b-bit input):
on ``cpu`` the reduced config at batch 8, seq 64, as the reference's step;
on ``cuda`` the published widths in bfloat16 at 2 layers, batch 2 at seq
4,096 (``--batch`` overrides the batch). grok-1 does not fit one card so:
its experts alone are 4.8 B parameters a layer. ``--mesh`` and
``--sample`` exit with the reference's reasons.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-12b \\
      --bits 2 --steps 2 --device cpu

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

``--mesh data=N`` trains on N ranks, one process each: the edges split by
destination over the ``data`` ranks, parameters replicated, gradients
all-reduced through the INT8 stochastic-rounding mean (``--allreduce
fp32``: the exact mean); ``--mesh data=N,model=M`` also stores the entity
table as row blocks across the ``model`` ranks
(``training.data_parallel``). The launcher spawns the ranks itself
(``launch.mesh.run_ranks``), or joins ``torchrun``'s. On ``cuda`` each rank
takes its own card with NCCL when there are enough cards, else all share
``cuda:0`` and talk over gloo; ``--device cpu`` runs the ranks on the CPU
over gloo. Every rank's loss is the same scalar; rank 0 logs, writes the
checkpoints (the full logical state, the files a single-device run
writes) and the sinks. A step that fails on any rank fails on every rank,
and all roll back to the last checkpoint and replay, up to the trainer's
``max_failures`` in a row, as on one device. A checkpoint carries the
mesh and the table placement, so a resume onto another mesh is refused;
``--reshard-from DIR`` starts from such a checkpoint on the current mesh
instead. The ``[dp]`` line names the backend and the collective route.

  PYTHONPATH=src python -m repro_torch.launch.train --arch kgat \\
      --mesh data=2,model=2 --allreduce int8 --steps 10 --device cpu

``train_kgnn`` is the same path as a function, so that a caller can drive
it at any size and for any KG model, R-GCN included (``chip_smoke.py`` runs
it at full width); ``train_model`` trains any ``ModelStep`` (the GCN's
shapes); ``train_kgnn_dp`` is the multi-rank one.
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
    family_of, model_config
from repro_torch.obs import StepLogWriter, get_tracer, log, \
    reset_registry, write_summary
from repro_torch.training.optimizer import adam
from repro_torch.training.step import make_train_step, step_metadata, \
    trainable
from repro_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["train_kgnn", "train_model", "train_kgnn_dp", "dp_job", "train_rank",
           "shard_setup", "main"]

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


def _failing_once(train_step, at: int):
    """``train_step`` (``data_parallel.make_dp_step``'s) handed an injected
    failure at step ``at``, once: the step carries it to the ranks'
    agreement point, so this rank still takes part in every collective."""
    fired = []

    def run(state, batch, i):
        fail = None
        if i == at and not fired:
            fired.append(i)
            fail = RuntimeError(f"injected failure at step {i}")
        return train_step(state, batch, i, fail=fail)

    return run


def train_kgnn(cfg, ds, params, schedule, steps: int, *, batch: int = 1024,
               device="cuda", graph=None, **kw) -> dict:
    """Train ``cfg.model`` (kgat, kgcn, kgin or rgcn) up to step ``steps``
    from a copy of ``params`` (the caller's stay as they were) under
    ``schedule``: ``train_model`` on the model's BPR step over ``ds``
    (``graph`` reuses a CKG already built on ``device``); the keywords
    are ``train_model``'s."""
    dev = resolve_device(device)
    # R-GCN's checkpoints say arch "kgat", model "rgcn"
    step = build_step(arch_of(cfg.model), ds=ds, cfg=cfg, batch_size=batch,
                      device=dev, graph=graph)
    return train_model(step, params, schedule, steps, **kw)


def train_model(step, params, schedule, steps: int, *, log_every: int = 1,
                log=None, ckpt_dir: str | None = None, ckpt_every: int = 10,
                schedule_spec: str | None = None, step_writer=None,
                opt_state=None, opt=None) -> dict:
    """Train ``step`` (a ``ModelStep``: a KG model's, or ``gcn-cora``'s on
    any of its shapes) up to step ``steps`` from a copy of ``params`` under
    ``schedule``, ``opt`` (an ``training.optimizer.Optimizer``; default
    Adam at ``step.lr``), rounding seeds from ``ROOT_SEED``;
    the throughput series counts ``step.data["n_edges"]`` edges a step.

    With ``ckpt_dir`` the run restores the latest checkpoint there first
    (refusing one of another arch, model or ``schedule_spec``), saves every
    ``ckpt_every`` steps and at the end, and rolls back to the last one on a
    failed step; without it, nothing is saved. ``step_writer`` (an
    ``obs.StepLogWriter``) gets one line a step.

    Returns ``steps``: one record per step run (``step``, ``loss``,
    ``seconds``, ``launches`` by kernel, ``max_memory_allocated`` on the
    card, and ``act``, the activation-bytes report of its saved residuals),
    and ``params``, the trained parameters.
    """
    dev = step.data["device"]
    opt = opt or adam(step.lr)
    p = trainable(params)
    train_step = _measured(make_train_step(step, opt, schedule=schedule,
                                           root_seed=ROOT_SEED), dev,
                           step_writer)
    trainer = Trainer(
        train_step, (p, opt.init(p) if opt_state is None else opt_state),
        step.batches(),
        TrainerConfig(total_steps=steps, log_every=log_every,
                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
        log_fn=log, ckpt_meta=step_metadata(step, schedule_spec),
        step_writer=step_writer, items_per_step=step.data.get("n_edges"),
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
                    help="BPR batch size (default 512; 256 with --sample); "
                         "recsys: CTR batch (default 4096 on the card, 256 "
                         "on the CPU)")
    ap.add_argument("--row-cap", type=int, default=None, metavar="N",
                    help="recsys: cap each embedding table at N rows")
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
    ap.add_argument("--mesh", default=None,
                    help="MeshSpec layout, e.g. data=2 (edges split over 2 "
                         "ranks) or data=2,model=2 (and the entity table "
                         "row-sharded over 2): one process a rank")
    ap.add_argument("--allreduce", default="int8", choices=["int8", "fp32"],
                    help="--mesh: gradient all-reduce (int8 = the "
                         "stochastic-rounding compressed mean)")
    ap.add_argument("--reshard-from", default=None, metavar="DIR",
                    help="start from the latest checkpoint under DIR "
                         "whatever mesh wrote it (arch and schedule still "
                         "checked), laid out on the current --mesh")
    args = ap.parse_args(argv)
    if args.sample and args.mesh:
        from repro_torch.training.data_parallel import check_no_sampled_dp
        try:
            check_no_sampled_dp(args.sample, mesh_spec=args.mesh)
        except NotImplementedError as e:
            raise SystemExit(f"error: {e}") from None
    mesh_spec = _parse_mesh(args.mesh) if args.mesh else None
    reset_registry()   # the summary holds this run's series alone
    schedule = schedule_from_cli(args.schedule, args.bits)
    label = schedule_label(args.schedule, args.bits)
    if mesh_spec is not None:
        return _run_dp(args, mesh_spec, schedule, label)
    dev = resolve_device(args.device)
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
    from repro_torch.training.tiering import run_sampled_training, \
        sampled_unsupported

    if args.ckpt:
        raise SystemExit("error: --sample takes no checkpoints (--ckpt)")
    try:
        fanouts = parse_fanouts(args.sample)
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    batch = args.batch or 256
    family = family_of(args.arch)
    if family != "kgnn":
        raise SystemExit(f"error: {sampled_unsupported(args.arch, family)}")
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
        "schedule": label, "steps": args.steps, "mesh": args.mesh,
        "sample": args.sample})
    print(f"[train] done; loss {report.losses[0]:.4f} -> "
          f"{report.losses[-1]:.4f}  hit-rate {report.hit_rate:.2%}  "
          f"rows/step {report.rows_transferred_per_step:.0f}  "
          f"hot-tier {report.store_device_bytes / 2**20:.2f} MiB of "
          f"{report.table_bytes / 2**20:.2f} MiB table")


def _run(args, dev, schedule, label: str) -> dict:
    family = family_of(args.arch)
    if family == "gnn":
        step = build_step(args.arch, device=dev)
    elif family == "recsys":
        try:
            step = build_step(args.arch, device=dev, batch_size=args.batch,
                              row_cap=args.row_cap)
        except ValueError as e:
            raise SystemExit(f"error: {e}") from None
    elif family in ("lm", "moe_lm"):
        step = build_step(args.arch, device=dev, batch_size=args.batch)
    else:
        step = build_step(args.arch, batch_size=args.batch or 512,
                          device=dev)
    run = {"kind": "train", "arch": args.arch, "family": step.family,
           "schedule": label, "steps": args.steps, "mesh": args.mesh,
           "sample": None}
    params = step.init(0)
    n = sum(t.numel() for v in params.values()
            for t in (v if isinstance(v, list) else [v]))
    log(f"[train] {args.arch} ({step.family}) {n / 1e6:.2f}M params "
        f"schedule={label} device={dev}")
    step_writer = (StepLogWriter(os.path.join(args.metrics_out,
                                              "steps.jsonl"))
                   if args.metrics_out else None)
    opt_state = None
    if args.reshard_from:
        params, opt_state = _reshard_from(args.reshard_from, step, params,
                                          label)
        log(f"[train] resharded checkpoint from {args.reshard_from} onto "
            f"1 device")
    try:
        res = train_model(
            step, params, schedule, args.steps,
            log_every=max(args.steps // 8, 5),
            ckpt_dir=args.ckpt or tempfile.mkdtemp(prefix="repro_ckpt_"),
            ckpt_every=max(args.steps // 4, 10), schedule_spec=label,
            step_writer=step_writer, opt_state=opt_state)
    finally:
        if step_writer is not None:
            step_writer.close()
    _finish_telemetry(args, run)
    return res


# -- several ranks (--mesh) -----------------------------------------------------


def _parse_mesh(spec: str):
    """``--mesh`` string -> validated ``MeshSpec`` (SystemExit on junk)."""
    from repro_torch.sharding.mesh_spec import MeshSpec, MeshSpecError

    try:
        return MeshSpec.parse(spec).check_axes(("data", "model"),
                                               required=("data",))
    except MeshSpecError as e:
        raise SystemExit(f"--mesh: {e}") from None


def _reshard_from(base: str, step, params, label: str):
    """The latest checkpoint under ``base`` (the full logical state),
    whatever mesh wrote it: arch, model and schedule are still checked."""
    from repro_torch.training.checkpoint import restore_checkpoint

    opt = adam(step.lr)
    got, state = restore_checkpoint(base, (params, opt.init(params)),
                                    expect_meta=step_metadata(step, label))
    if got is None:
        raise SystemExit(f"--reshard-from: no checkpoint found under {base}")
    return state


def dp_job(cfg, ds, schedule, steps: int, *, batch: int = 1024,
           allreduce: str = "int8",
           ckpt_dir: str | None = None, ckpt_every: int = 10,
           schedule_spec: str | None = None,
           reshard_from: str | None = None, log_every: int = 1,
           metrics_out: str | None = None,
           trace: str | None = None, verbose: bool = True,
           run: dict | None = None,
           fail_at: tuple[int, int] | None = None) -> dict:
    """The description of one multi-rank training run that ``train_rank``
    carries out on each rank (the arguments of ``train_kgnn_dp``).
    ``fail_at=(rank, step)`` injects one failure on that rank at that step
    (tests: every rank rolls back and replays)."""
    return dict(cfg=cfg, ds=ds, schedule=schedule, steps=steps, batch=batch,
                allreduce=allreduce,
                ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                schedule_spec=schedule_spec, reshard_from=reshard_from,
                log_every=log_every, metrics_out=metrics_out, trace=trace,
                verbose=verbose, run=run, fail_at=fail_at)


def train_kgnn_dp(cfg, ds, schedule, steps: int, *, mesh, device="cuda",
                  **kw) -> list:
    """Train ``cfg.model`` on the ranks of ``mesh`` (a ``MeshSpec`` or its
    string) up to step ``steps``, from the seed-0 parameters
    (or ``reshard_from``'s checkpoint), under ``schedule``, through
    ``training.data_parallel.make_dp_step`` with ``allreduce``'s
    all-reduce (``int8`` or ``fp32``); the replicated parameters are held
    bitwise equal across the ranks after every step.
    One process a rank (``launch.mesh.run_ranks``), each running
    ``train_rank``; the keywords are ``dp_job``'s. Without ``ckpt_dir`` a
    temporary directory made here, before the ranks start, takes the
    checkpoints (a failed step rolls back to them) and is removed after.

    Returns one dict a rank: ``steps`` (per step ``loss``, ``seconds``,
    ``launches`` by kernel, ``max_memory_allocated``), ``counts`` (kernel
    launches of the whole run), ``peak`` (the rank's peak allocated device
    memory, None on the CPU), ``shard`` (every shard's edges and halo
    rows, the caps), ``mesh`` (backend, route, device),
    ``allreduce_bytes`` (the analytic report on this rank's leaves, int8
    and fp32), ``allreduce_sent`` (the bytes this rank hands its
    all-reduce calls, int8 and fp32) and ``log`` (the trainer's lines on
    this rank)."""
    import shutil

    from repro_torch.launch.mesh import run_ranks

    job = dp_job(cfg, ds, schedule, steps, **kw)
    made = job["ckpt_dir"] is None
    if made:
        job["ckpt_dir"] = tempfile.mkdtemp(prefix="repro_ckpt_")
    try:
        return run_ranks(train_rank, str(mesh), device=str(device),
                         args=(job,))
    finally:
        if made:
            shutil.rmtree(job["ckpt_dir"], ignore_errors=True)


def shard_setup(step, mesh, cache: dict | None = None):
    """``(part, view, model_axis)`` of ``step`` on this rank: the edge
    partition and the shard's view, built on the host once (and kept in
    ``cache`` for later runs of the same graph and mesh)."""
    from repro_torch.training import data_parallel as dp

    key = (id(step.dp_spec.graph), str(mesh.spec))
    if cache is not None and key in cache:
        return cache[key]
    model_axis = "model" if "model" in mesh.spec.names else None
    part = dp.partition_graph(step.dp_spec.graph, mesh)
    out = (part, dp.shard_view(step.dp_spec, part, mesh,
                               model_axis=model_axis), model_axis)
    if cache is not None:
        cache[key] = out
    return out


def train_rank(rt, job: dict, cache: dict | None = None) -> dict:
    """One rank of ``train_kgnn_dp``: ``job`` is a ``dp_job``, ``rt`` the
    rank's ``launch.mesh.RankRuntime``; ``cache`` keeps the shard's
    partition and view across runs of one process.

    The trainer takes its default ``max_failures`` and checkpoints to
    ``job["ckpt_dir"]`` (rank 0's, where ranks joined from ``torchrun``
    made their own): a step that fails on any rank fails on every rank
    (``data_parallel.make_dp_step``), and all roll back to the same
    checkpoint and replay."""
    import torch.distributed as dist

    from repro_torch.kernels.backend import reset_counts
    from repro_torch.training import data_parallel as dp
    from repro_torch.training.checkpoint import RankCheckpoints
    from repro_torch.sharding.comm import ROUTE
    from repro_torch.training.compress import allreduce_byte_report, \
        allreduce_sent_bytes

    if not job["ckpt_dir"]:
        raise ValueError("train_rank needs a checkpoint directory "
                         "(train_kgnn_dp makes a temporary one)")
    cfg, ds, mesh, dev = job["cfg"], job["ds"], rt.mesh, rt.device
    say = log if rt.is_root and job["verbose"] else (lambda *_, **__: None)
    ckpt_dir = [job["ckpt_dir"]]
    dist.broadcast_object_list(ckpt_dir, src=0)
    lines: list[str] = []

    def trainer_log(msg: str) -> None:
        lines.append(msg)
        say(msg)

    if rt.is_root and job["trace"]:
        get_tracer().enable()
    step = build_step(arch_of(cfg.model), ds=ds, cfg=cfg,
                      batch_size=job["batch"], device=dev,
                      device_graph=False)
    spec = step.dp_spec
    part, view, model_axis = shard_setup(step, mesh, cache)
    placement = spec.placement_str() if model_axis else None
    opt = adam(step.lr)
    params = step.init(0)
    logical = (params, opt.init(params))

    def to_local(state):
        if model_axis is not None:
            state = dp.block_rows(dp.pad_row_sharded(
                state, spec, part, mesh.shape[model_axis]), spec, part, mesh)
        return trainable(state[0]), state[1]

    def to_logical(state):
        if model_axis is None:
            return state
        return dp.unpad_row_sharded(dp.gather_row_blocks(
            state, spec, part, mesh), spec, part.n_nodes)

    state = logical
    if job["reshard_from"]:
        state = _reshard_from(job["reshard_from"], step, params,
                              job["schedule_spec"])
        say(f"[train] resharded checkpoint from {job['reshard_from']} onto "
            f"mesh {mesh.spec}")
    state = to_local(state)
    del logical, params
    counts = part.edge_counts().tolist()
    say(f"[dp] {step.arch} ({cfg.model}): mesh {mesh.spec}, {rt.world_size} "
        f"ranks, backend {mesh.backend}, collective route {ROUTE}, "
        f"rank 0 on {dev}, allreduce={job['allreduce']}; edges/shard "
        f"{counts} (cap {part.e_cap}), halo rows/shard "
        f"{part.halo_count.tolist()} (cap {part.h_cap}), rows/shard "
        f"{part.rows_per_shard}"
        + (f", row-sharded [{placement}] over model="
           f"{mesh.shape[model_axis]}" if model_axis else ""))
    train_step = dp.make_dp_step(
        step, part, mesh, opt, schedule=job["schedule"], root_seed=ROOT_SEED,
        mesh_spec=mesh.spec, compress_grads=job["allreduce"] == "int8",
        view=view)
    if job["fail_at"] is not None and rt.rank == job["fail_at"][0]:
        train_step = _failing_once(train_step, job["fail_at"][1])
    step_writer = (StepLogWriter(os.path.join(job["metrics_out"],
                                              "steps.jsonl"))
                   if rt.is_root and job["metrics_out"] else None)
    meta = step_metadata(step, job["schedule_spec"], mesh_spec=mesh.spec,
                         placement=placement)
    trainer = Trainer(
        _measured(train_step, dev, step_writer), state, step.batches(),
        TrainerConfig(total_steps=job["steps"], log_every=job["log_every"],
                      ckpt_every=job["ckpt_every"]),
        log_fn=trainer_log, ckpt_meta=meta, step_writer=step_writer,
        items_per_step=len(ds.src))
    trainer.ckpt = RankCheckpoints(
        ckpt_dir[0], is_root=rt.is_root, to_logical=to_logical,
        to_local=to_local, logical_template=to_logical(state), mesh=mesh,
        meta=meta)
    trainer.restore_if_available()
    reset_counts()
    try:
        params_out, _ = trainer.run()
    finally:
        if step_writer is not None:
            step_writer.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    counts_run = dict(LAUNCH_COUNTS)
    if rt.is_root and (job["trace"] or job["metrics_out"]):
        run = job["run"] or {"kind": "train", "arch": step.arch,
                             "family": step.family,
                             "schedule": job["schedule_spec"],
                             "steps": job["steps"], "mesh": str(mesh.spec),
                             "sample": None}
        _finish_telemetry(argparse.Namespace(trace=job["trace"],
                                             metrics_out=job["metrics_out"]),
                          run)
        get_tracer().disable()
    axes = ("data", model_axis) if model_axis else "data"
    sharded_over = ({n: model_axis for n in spec.row_sharded()}
                    if model_axis else None)
    return {
        "steps": [{k: v for k, v in r.items() if k != "act"}
                  for r in trainer.history],
        "counts": counts_run,
        "peak": (max((r["max_memory_allocated"] for r in trainer.history),
                     default=0) if dev.type == "cuda" else None),
        "shard": {"e_cap": part.e_cap, "h_cap": part.h_cap,
                  "rows": part.rows_per_shard, "edges_all": counts,
                  "halo_all": part.halo_count.tolist()},
        "mesh": {"spec": str(mesh.spec), "backend": mesh.backend,
                 "route": ROUTE, "device": str(dev)},
        "log": lines,
        **{key: {w: report(params_out, axes, placement=sharded_over,
                           compressed=w == "int8") for w in ("int8", "fp32")}
           for key, report in (("allreduce_bytes", allreduce_byte_report),
                               ("allreduce_sent", allreduce_sent_bytes))},
    }


def _run_dp(args, mesh_spec, schedule, label: str) -> None:
    """--mesh: the launcher's default step on the mesh's ranks."""
    family = family_of(args.arch)
    step = (build_step(args.arch, device="cpu") if family != "kgnn" else
            build_step(args.arch, batch_size=args.batch or 512, device="cpu",
                       device_graph=False))
    if step.dp_spec is None:
        raise SystemExit(f"--mesh: data parallelism is not implemented for "
                         f"--arch {args.arch} ({family}): "
                         f"{step.dp_unsupported}")
    run = {"kind": "train", "arch": args.arch, "family": step.family,
           "schedule": label, "steps": args.steps, "mesh": str(mesh_spec),
           "sample": None}
    res = train_kgnn_dp(
        step.cfg, step.data["dataset"], schedule, args.steps,
        mesh=mesh_spec, device=args.device, batch=args.batch or 512,
        allreduce=args.allreduce, ckpt_dir=args.ckpt,
        ckpt_every=max(args.steps // 4, 10), schedule_spec=label,
        reshard_from=args.reshard_from, log_every=max(args.steps // 8, 5),
        metrics_out=args.metrics_out, trace=args.trace, run=run)
    hist = res[0]["steps"]
    if not hist:
        print(f"[train] done; nothing to run past step {args.steps}")
        return
    rep = res[0]["allreduce_bytes"][args.allreduce]
    sent = res[0]["allreduce_sent"][args.allreduce]
    print(f"[train] {mesh_spec}: {len(res)} ranks, all-reduce "
          f"{sum(r['bytes'] for r in rep)} B/step analytic ({args.allreduce}"
          f"; " + ", ".join(f"{r['axes']} {r['bytes']}" for r in rep)
          + f"), {sum(r['bytes'] for r in sent)} B/step sent")
    losses = [r["loss"] for r in hist]
    print(f"[train] done; loss {losses[0]:.4f} -> {losses[-1]:.4f}")


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
