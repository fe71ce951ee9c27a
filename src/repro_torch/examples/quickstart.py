"""Quickstart: TinyKG in a page (port of ``examples/quickstart.py``).

Trains KGAT on a small synthetic knowledge graph under the FP32 baseline,
INT2-compressed activations and the per-site schedule INT8 first layer /
INT2 rest, then ranks every item for every user through the streaming
evaluator and prints Recall@20, NDCG@20, the activation bytes the first
step saved and the median step time.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import statistics

import torch

from repro_torch.core.policy import first_layer_int8_rest_int2, \
    policy_for_bits
from repro_torch.data.synthetic import gen_kg_dataset
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.train import train_kgnn
from repro_torch.models import kgnn
from repro_torch.serving.eval import streaming_eval_dataset
from repro_torch.serving.store import build_kgnn_store
from repro_torch.training.optimizer import adam

# the reference's quickstart: benchmarks.common's dataset and cell
DATASET = dict(n_users=200, n_items=300, n_attrs=150, n_relations=6,
               n_triples=2000, inter_per_user=20, seed=0)
DIM, BATCH, LR = 32, 256, 5e-3


def run(name: str, schedule, ds, cfg, steps: int, dev) -> dict:
    """Train ``cfg`` under ``schedule`` from seed-0 parameters and evaluate
    it (the reference's ``benchmarks.common.train_kgnn`` cell)."""
    g = ds.graph(dev)
    params = kgnn.init_params(cfg, seed=0, device=dev)
    res = train_kgnn(cfg, ds, params, schedule, steps, batch=BATCH,
                     device=dev, graph=g, opt=adam(LR),
                     log=lambda msg: None)
    with torch.no_grad():
        store = build_kgnn_store(res["params"], g, cfg, ds.n_items,
                                 bits=None)
        recall, ndcg = streaming_eval_dataset(store, ds, k=20)
    act = res["steps"][0]["act"]
    return {"name": name, "recall@20": recall, "ndcg@20": ndcg,
            "act_mem_bytes": act["total_bytes"],
            "act_mem_ratio": act["compression_ratio"],
            "step_ms": statistics.median(r["seconds"]
                                         for r in res["steps"]) * 1e3,
            "losses": [r["loss"] for r in res["steps"]]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else "cpu")
    ds = gen_kg_dataset(**DATASET)
    print(f"KG: {ds.n_users} users, {ds.n_items} items, {ds.n_nodes} "
          f"nodes, {len(ds.src)} edges")
    cfg = kgnn.KGNNConfig(model="kgat", n_users=ds.n_users,
                          n_entities=ds.n_entities,
                          n_relations=ds.n_relations, dim=DIM, n_layers=3,
                          readout="concat", l2=1e-5)
    rows = [run(name, sched, ds, cfg, args.steps, dev) for name, sched in (
        ("FP32", policy_for_bits(None)), ("TinyKG INT2", policy_for_bits(2)),
        ("INT8/INT2", first_layer_int8_rest_int2()))]
    print(f"\n{'':14s}{'Recall@20':>11s}{'NDCG@20':>9s}"
          f"{'ActMem':>10s}{'ms/step':>9s}")
    for r in rows:
        print(f"{r['name']:14s}{r['recall@20']:11.4f}{r['ndcg@20']:9.4f}"
              f"{r['act_mem_bytes'] / 2**20:9.2f}M{r['step_ms']:9.1f}")
    fp32, int2 = rows[0], rows[1]
    print(f"\nactivation compression: {int2['act_mem_ratio']:.1f}x "
          f"(paper reports ~7x at INT2)")
    drop = 100 * (fp32["recall@20"] - int2["recall@20"]) \
        / max(fp32["recall@20"], 1e-12)
    print(f"accuracy delta: {drop:+.2f}% (paper: < 2%)")
    return rows


if __name__ == "__main__":
    main()
