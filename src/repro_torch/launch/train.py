"""KGAT training launcher (port of the single-device path of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch kgat --steps 10 \\
      --bits 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch kgat --steps 100 \\
      --schedule first_layer_int8_rest_int2

Full-graph KGAT with activation-compressed training (ACT): the reference's
defaults from ``models.registry.build_step`` (the small synthetic CKG, dim
32, 3 layers, batch 512, Adam at lr 3e-3), parameters from seed 0 and
rounding seeds from root seed 1. ``--schedule`` takes a ``PolicySchedule``
spec (preset, uniform bit-width, or ordered ``[kind:]glob=bits`` rules; see
``repro_torch.core.policy.parse_schedule``); ``--bits`` is the uniform
fast path, 0 the FP32 baseline. On ``cuda`` (the default; without a card
it raises) every kernel of the path is a hand-written CUDA kernel;
``--device cpu`` runs their plain versions.

``train_kgnn`` is the same path as a function, so that a caller can drive
it at any size (``chip_smoke.py`` runs it at full width). Checkpoints and
the ``obs`` telemetry of the reference's launcher are not ported yet.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.policy import schedule_from_cli, schedule_label
from repro_torch.kernels.backend import LAUNCH_COUNTS, resolve_device
from repro_torch.models.registry import archs, build_step
from repro_torch.training.optimizer import adam
from repro_torch.training.step import make_train_step, trainable
from repro_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["train_kgnn", "main"]

ROOT_SEED = 1     # the reference launcher's root key is PRNGKey(1)


def _measured(train_step, dev: torch.device):
    """Wrap a train step to add its kernel launches and, on the card, its
    peak allocated device memory to the step's metrics."""

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
        return state, metrics

    return run


def train_kgnn(cfg, ds, params, schedule, steps: int, *, batch: int = 1024,
               device="cuda", graph=None, log_every: int = 1,
               log=print) -> dict:
    """Train KGAT ``steps`` steps from a copy of ``params`` (the caller's
    stay as they were) under ``schedule``.

    Returns ``steps``: one record per step (``loss``, ``seconds``,
    ``launches`` by kernel, ``max_memory_allocated`` on the card, and
    ``act``, the activation-bytes report of its saved residuals), and
    ``params``, the trained parameters. ``graph`` reuses a CKG already
    built on ``device``.
    """
    dev = resolve_device(device)
    step = build_step(cfg.model, ds=ds, cfg=cfg, batch_size=batch,
                      device=dev, graph=graph)
    opt = adam(step.lr)
    p = trainable(params)
    train_step = _measured(make_train_step(step, opt, schedule=schedule,
                                           root_seed=ROOT_SEED), dev)
    trainer = Trainer(train_step, (p, opt.init(p)), step.batches(),
                      TrainerConfig(total_steps=steps, log_every=log_every),
                      log_fn=log)
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
    ap.add_argument("--batch", type=int, default=512, help="BPR batch size")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the kernels; cpu their plain versions")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (not ported yet: raises)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.ckpt is not None:
        raise NotImplementedError(
            "checkpoint save/restore and replay are not ported yet "
            "(ROADMAP Queue 1, slice 2 deferred items)")
    schedule = schedule_from_cli(args.schedule, args.bits)
    label = schedule_label(args.schedule, args.bits)
    step = build_step(args.arch, batch_size=args.batch, device=dev)
    params = step.init(0)
    n = sum(t.numel() for v in params.values()
            for t in (v if isinstance(v, list) else [v]))
    print(f"[train] {args.arch} ({step.family}) {n / 1e6:.2f}M params "
          f"schedule={label} device={dev}")
    res = train_kgnn(step.cfg, step.data["dataset"], params, schedule,
                     args.steps, batch=args.batch, device=dev,
                     graph=step.data["graph"],
                     log_every=max(args.steps // 8, 5))
    act = res["steps"][0]["act"]
    print(f"[train] activation footprint {act['total_bytes'] / 2**20:.3f} "
          f"MiB ({act['compression_ratio']:.1f}x vs fp32)")
    losses = [r["loss"] for r in res["steps"]]
    print(f"[train] done; loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
