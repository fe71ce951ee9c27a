"""End-to-end driver: train a ~100M-parameter KGIN with the full stack of
the port (port of ``examples/train_kgnn.py``): the model-step registry,
the fault-tolerant trainer with checkpoints that carry the run's identity,
step-keyed rounding seeds, Adam with a cosine warm-up schedule and
global-norm clipping, then Recall/NDCG through the streaming evaluator.

The ~100M parameters are the entity and relation tables (the KGNN regime:
parameters grow with N·d): 600k entities x d 160 at ``--scale 1.0``.

    PYTHONPATH=src python -m repro_torch.examples.train_kgnn \\
        [--steps 300] [--bits 2] [--scale 1.0] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.core.policy import schedule_from_cli, schedule_label
from repro_torch.data.synthetic import gen_kg_dataset
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.train import train_model
from repro_torch.models import kgnn
from repro_torch.models.registry import build_step
from repro_torch.serving.eval import streaming_eval_dataset
from repro_torch.serving.store import build_kgnn_store
from repro_torch.training.optimizer import adam, cosine_warmup

BATCH = 4096


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--dim", type=int, default=160)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="graph size multiplier")
    ap.add_argument("--schedule", default=None,
                    help="PolicySchedule spec (e.g. "
                         "first_layer_int8_rest_int2); overrides --bits")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~600k entities at scale=1.0 -> ~100M embedding params at dim=160
    ds = gen_kg_dataset(
        n_users=int(120_000 * args.scale), n_items=int(200_000 * args.scale),
        n_attrs=int(280_000 * args.scale), n_relations=12,
        n_triples=int(1_200_000 * args.scale), inter_per_user=12, seed=0)
    cfg = kgnn.KGNNConfig(
        model="kgin", n_users=ds.n_users, n_entities=ds.n_entities,
        n_relations=ds.n_relations, dim=args.dim, n_layers=3, readout="sum")
    schedule = schedule_from_cli(args.schedule, args.bits)
    label = schedule_label(args.schedule, args.bits)

    # one step definition, from the registry: the object the launcher and
    # the multi-rank path train
    step = build_step("kgin", ds=ds, cfg=cfg, batch_size=BATCH, device=dev)
    params = step.init(0)
    n_params = sum(t.numel() for v in params.values()
                   for t in (v if isinstance(v, list) else [v]))
    print(f"model: kgin dim={args.dim} | {n_params / 1e6:.1f}M params | "
          f"{step.data['n_edges'] / 1e6:.2f}M edges | schedule {label} | "
          f"device {dev}", flush=True)

    opt = adam(cosine_warmup(3e-3, warmup=50, total=args.steps),
               clip_norm=1.0)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="kgin_ckpt_")
    res = train_model(step, params, schedule, args.steps, opt=opt,
                      log_every=25, ckpt_dir=ckpt_dir, ckpt_every=100,
                      schedule_spec=label)
    losses = [r["loss"] for r in res["steps"]]
    with torch.no_grad():
        store = build_kgnn_store(res["params"], step.data["graph"], cfg,
                                 ds.n_items, bits=None)
        recall, ndcg = streaming_eval_dataset(store, ds, k=20)
    if losses:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
              f"{len(losses)} steps")
    print(f"final: recall@20={recall:.4f} ndcg@20={ndcg:.4f} "
          f"(ckpts in {ckpt_dir})", flush=True)
    return {"losses": losses, "recall@20": recall, "ndcg@20": ndcg,
            "steps": res["steps"], "n_params": n_params}


if __name__ == "__main__":
    main()
