"""KGAT serving launcher (port of the kgnn path of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch kgat --bits 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch kgat --bits 8 \\
      --two-stage 4 --item-shards 2 --cache 64 --refresh-steps 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch kgat --bits 4 \\
      --requests 50 --device cpu

Runs the reduced KGAT config end to end: the synthetic CKG, parameters from
``init_params`` trained ``--train-steps`` quick BPR steps (FP32, Adam at
5e-3, batch 128, as the reference launcher), one FP32 rollout into a packed
``QuantizedEmbeddingStore`` at ``--bits``, the micro-batching engine
(QPS and latency percentiles) with the tier-2 options (two-stage retrieval,
item shards, hot-user cache, bounded queue), an optional delta refresh after
``--refresh-steps`` more steps with a second burst served from the new
store, and the streaming full-ranking evaluator checked against the dense
reference. On ``cuda`` (the default) the rollout's SPMM, the quantizer, the
top-K and coarse scans and the re-rank's dequantize run the hand-written
kernels; ``--device cpu`` runs their plain versions.

``serve_kgnn`` is the same path as a function, so that a caller can drive it
at any size (``chip_smoke.py`` runs it at full width).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get
from repro_torch.configs.smoke import reduced
from repro_torch.data.synthetic import bpr_batches, gen_kg_dataset
from repro_torch.kernels.backend import LAUNCH_COUNTS, full_fp32, \
    resolve_device
from repro_torch.models import kgnn
from repro_torch.models.layers import param_leaves
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.eval import streaming_eval_dataset, \
    streaming_recall_ndcg
from repro_torch.serving.store import build_kgnn_store, padded_pos_lists
from repro_torch.training.metrics import recall_ndcg_at_k
from repro_torch.training.optimizer import adam
from repro_torch.training.step import trainable

__all__ = ["serve_kgnn", "bpr_trainer", "reduced_dataset", "main"]

TRAIN_LR = 5e-3        # the reference launcher's quick training
TRAIN_BATCH = 128


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counts() -> dict:
    return dict(LAUNCH_COUNTS)


def _diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def bpr_trainer(cfg, ds, g, params):
    """The reference launcher's quick training: ``train(n) -> loss`` takes
    n BPR steps (FP32, no ACT policy; Adam at 5e-3; batches of 128 from
    ``bpr_batches(ds, 128, seed=0)``) on a trainable copy of ``params``,
    which ``train.params`` holds."""
    p = trainable(params)
    opt = adam(TRAIN_LR)
    state = {"opt": opt.init(p)}
    batches = bpr_batches(ds, TRAIN_BATCH, seed=0)
    dev = g.src.device

    def train(n: int) -> float:
        loss = None
        for _ in range(n):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(batches).items()}
            with full_fp32():
                loss = kgnn.bpr_loss(p, g, batch, cfg)
                grads = torch.autograd.grad(loss, param_leaves(p))
            _, state["opt"] = opt.update(grads, state["opt"], p)
        return float(loss.detach())

    train.params = p
    return train


def serve_kgnn(cfg, ds, params, *, bits: int | None, k: int = 20,
               requests: int = 20, device="cuda", graph=None,
               dense_users: int | None = None, seed: int = 0,
               users=None, train_steps: int = 0,
               two_stage: int | None = None, item_shards: int = 1,
               cache: int = 0, max_pending: int = 1024,
               refresh_steps: int = 0, log=print) -> dict:
    """Train -> rollout -> packed store -> engine burst -> [refresh ->
    burst] -> streaming eval vs dense.

    ``graph`` reuses a CKG already built on ``device`` (else it is built
    from ``ds``). ``users`` is the burst's request stream (default:
    ``requests`` uniform user ids from ``seed``). ``train_steps`` quick BPR
    steps run before the rollout; ``refresh_steps`` more after the first
    burst, then the store is rolled out again and hot-swapped through the
    engine's delta refresh and the burst is served again. ``two_stage``
    (C), ``item_shards``, ``cache`` and ``max_pending`` configure the
    engine. ``dense_users`` limits the dense reference, and the streaming
    evaluation it is compared with, to the first that many users (None:
    all); both run on the live store. Returns the stores, stats, results,
    metrics and, per phase, the kernel launches it made and its wall time.
    """
    dev = resolve_device(device)
    g = graph if graph is not None else ds.graph(dev)
    out: dict = {"phases": {}}

    def phase(name, fn):
        c0 = _counts()
        _sync(dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        out["phases"][name] = {"seconds": time.perf_counter() - t0,
                               "launches": _diff(_counts(), c0)}
        return res

    if train_steps or refresh_steps:
        train = bpr_trainer(cfg, ds, g, params)
        params = train.params
    if train_steps:
        loss = phase("train", lambda: train(train_steps))
        log(f"[serve] rollout after {train_steps} BPR steps "
            f"(loss {loss:.4f})")

    def rollout():
        return build_kgnn_store(params, g, cfg, ds.n_items, bits=bits)

    store = phase("rollout", rollout)
    mem = store.memory_report()
    log(f"[serve] store: bits={bits or 'fp32'} {mem['total_bytes']} B total "
        f"({mem['packed_bytes']} packed + {mem['scale_zero_bytes']} "
        f"scale/zero) vs {mem['fp32_bytes']} B fp32: "
        f"{mem['compression_ratio']:.2f}x")

    k = min(k, ds.n_items)
    if two_stage and bits is None:
        log("[serve] --two-stage needs a packed store; ignored at fp32")
        two_stage = None
    exclude = padded_pos_lists(ds.train_pos, ds.n_users)
    if users is None:
        users = np.random.default_rng(seed).integers(0, ds.n_users, requests)
    users = np.asarray(users)
    with ServingEngine(store, k=k, exclude=exclude, buckets=(1, 2, 4, 8),
                       two_stage_c=two_stage or None,
                       item_shards=item_shards, cache_size=cache,
                       max_pending=max_pending) as eng:
        phase("warmup", eng.warmup)

        def burst():
            futs = [eng.submit(int(u)) for u in users]
            return [f.result(timeout=300) for f in futs]

        results = phase("engine", burst)
        stats = eng.stats()
        log(f"[serve] kgat: {stats}")
        log(f"[serve] sample top-{min(k, 10)}: {results[0][1][:10]}")
        out.update(store=store, stats=stats, results=results,
                   label=eng.label)
        if refresh_steps:
            loss = phase("refresh_train", lambda: train(refresh_steps))
            new_store = phase("refresh_rollout", rollout)
            delta = phase("refresh",
                          lambda: eng.refresh(new_store).result(timeout=300))
            log(f"[serve] refresh v{delta['version']} after "
                f"{refresh_steps} more steps (loss {loss:.4f}): "
                f"{delta['rows_changed']}/{delta['rows_total']} rows "
                f"changed ({delta['changed_frac']:.1%}), "
                f"{delta['delta_bytes']} delta B")
            out.update(new_store=new_store, delta=delta,
                       results_post=phase("engine_post", burst))
            out["stats_post"] = eng.stats()
            log(f"[serve] post-refresh: {out['stats_post']}")
        live = eng.store

    r_s, n_s = phase("eval", lambda: streaming_eval_dataset(live, ds, k=k))
    n_dense = ds.n_users if dense_users is None else min(dense_users,
                                                         ds.n_users)

    def dense():
        sub = live.first_users(n_dense)
        r_sub, n_sub = (r_s, n_s) if n_dense == ds.n_users else \
            streaming_recall_ndcg(sub, ds.train_pos, ds.test_pos, k=k)
        scores = sub.user_vectors(torch.arange(n_dense, device=dev)) \
            @ live.item_matrix().T
        tr, te = (torch.from_numpy(a).to(dev)
                  for a in ds.interaction_matrices(n_dense))
        r_d, n_d = recall_ndcg_at_k(scores, te, tr, k=k)
        return r_sub, n_sub, r_d, n_d

    r_sub, n_sub, r_d, n_d = phase("dense_reference", dense)
    delta = max(abs(r_sub - r_d), abs(n_sub - n_d))
    log(f"[serve] streaming eval recall@{k}={r_s:.4f} ndcg@{k}={n_s:.4f} "
        f"| first {n_dense} users: streaming {r_sub:.6f}/{n_sub:.6f}, "
        f"dense reference {r_d:.6f}/{n_d:.6f} (|delta| {delta:.2e})")
    out.update(live_store=live, memory=mem, users=users, k=k, recall=r_s,
               ndcg=n_s, dense_users=n_dense, recall_sub=r_sub,
               ndcg_sub=n_sub, recall_dense=r_d, ndcg_dense=n_d,
               dense_delta=delta)
    return out


def reduced_dataset(cfg):
    """The synthetic CKG sized to a reduced config's node/relation space
    (the JAX launcher's arguments)."""
    return gen_kg_dataset(n_users=cfg.n_users,
                          n_items=cfg.n_entities * 3 // 5,
                          n_attrs=cfg.n_entities - cfg.n_entities * 3 // 5,
                          n_relations=(cfg.n_relations - 2) // 2,
                          n_triples=400, inter_per_user=8, seed=0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--bits", default="8", choices=["8", "4", "fp32"],
                    help="store precision")
    ap.add_argument("--k", type=int, default=20, help="top-K size")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--train-steps", type=int, default=30,
                    help="quick BPR steps before the serving rollout")
    ap.add_argument("--two-stage", type=int, default=None, metavar="C",
                    help="two-stage retrieval: coarse-scan packed codes, "
                         "re-rank C*k candidates in fp32 (packed stores)")
    ap.add_argument("--item-shards", type=int, default=1, metavar="S",
                    help="score S item shards concurrently, merge on the "
                         "host (bit-identical to one shard)")
    ap.add_argument("--cache", type=int, default=0, metavar="N",
                    help="hot-user result cache capacity (0 = off)")
    ap.add_argument("--max-pending", type=int, default=1024, metavar="N",
                    help="submit-queue bound; a full queue raises "
                         "BackpressureError")
    ap.add_argument("--refresh-steps", type=int, default=0, metavar="T",
                    help="after the first burst, train T more steps and "
                         "hot-swap the store through a delta refresh")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the kernels; cpu their plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced(get(args.arch)).model_cfg
    ds = reduced_dataset(cfg)
    params = kgnn.init_params(cfg, seed=0, device=dev)
    bits = None if args.bits == "fp32" else int(args.bits)
    serve_kgnn(cfg, ds, params, bits=bits, k=args.k,
               requests=args.requests, device=dev,
               train_steps=args.train_steps, two_stage=args.two_stage,
               item_shards=args.item_shards, cache=args.cache,
               max_pending=args.max_pending,
               refresh_steps=args.refresh_steps)


if __name__ == "__main__":
    main()
