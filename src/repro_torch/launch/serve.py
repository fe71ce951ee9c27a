"""KGAT serving launcher (port of the kgnn path of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch kgat --bits 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch kgat --bits 4 \\
      --requests 50 --device cpu

Runs the reduced KGAT config end to end: the synthetic CKG, parameters from
``init_params`` (no BPR training steps yet), one FP32 rollout into a packed
``QuantizedEmbeddingStore`` at ``--bits``, the micro-batching engine over the
fused top-K scorer (QPS and latency percentiles), and the streaming
full-ranking evaluator checked against the dense reference. On ``cuda`` (the
default) the rollout's SPMM, the quantizer and the scorer run the
hand-written kernels; ``--device cpu`` runs their plain versions.

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
from repro_torch.data.synthetic import gen_kg_dataset
from repro_torch.kernels.backend import LAUNCH_COUNTS, resolve_device
from repro_torch.models import kgnn
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.eval import streaming_eval_dataset, \
    streaming_recall_ndcg
from repro_torch.serving.store import build_kgnn_store, padded_pos_lists
from repro_torch.training.metrics import recall_ndcg_at_k

__all__ = ["serve_kgnn", "reduced_dataset", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counts() -> dict:
    return dict(LAUNCH_COUNTS)


def _diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def serve_kgnn(cfg, ds, params, *, bits: int | None, k: int = 20,
               requests: int = 20, device="cuda", graph=None,
               dense_users: int | None = None, seed: int = 0,
               log=print) -> dict:
    """Rollout -> packed store -> engine burst -> streaming eval vs dense.

    ``graph`` reuses a CKG already built on ``device`` (else it is built
    from ``ds``). ``dense_users`` limits the dense reference, and the
    streaming evaluation it is compared with, to the first that many users
    (None: all). Returns the store, stats, metrics and, per phase, the
    kernel launches it made and its wall time.
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

    store = phase("rollout", lambda: build_kgnn_store(
        params, g, cfg, ds.n_items, bits=bits))
    mem = store.memory_report()
    log(f"[serve] store: bits={bits or 'fp32'} {mem['total_bytes']} B total "
        f"({mem['packed_bytes']} packed + {mem['scale_zero_bytes']} "
        f"scale/zero) vs {mem['fp32_bytes']} B fp32: "
        f"{mem['compression_ratio']:.2f}x")

    k = min(k, ds.n_items)
    exclude = padded_pos_lists(ds.train_pos, ds.n_users)
    rng = np.random.default_rng(seed)
    users = rng.integers(0, ds.n_users, requests)
    with ServingEngine(store, k=k, exclude=exclude,
                       buckets=(1, 2, 4, 8)) as eng:
        phase("warmup", eng.warmup)

        def burst():
            futs = [eng.submit(int(u)) for u in users]
            return [f.result(timeout=300) for f in futs]

        results = phase("engine", burst)
        stats = eng.stats()
    log(f"[serve] kgat: {stats}")
    log(f"[serve] sample top-{min(k, 10)}: {results[0][1][:10]}")

    r_s, n_s = phase("eval", lambda: streaming_eval_dataset(store, ds, k=k))
    n_dense = ds.n_users if dense_users is None else min(dense_users,
                                                         ds.n_users)

    def dense():
        sub = store.first_users(n_dense)
        r_sub, n_sub = (r_s, n_s) if n_dense == ds.n_users else \
            streaming_recall_ndcg(sub, ds.train_pos, ds.test_pos, k=k)
        scores = sub.user_vectors(torch.arange(n_dense, device=dev)) \
            @ store.item_matrix().T
        tr, te = (torch.from_numpy(a).to(dev)
                  for a in ds.interaction_matrices(n_dense))
        r_d, n_d = recall_ndcg_at_k(scores, te, tr, k=k)
        return r_sub, n_sub, r_d, n_d

    r_sub, n_sub, r_d, n_d = phase("dense_reference", dense)
    delta = max(abs(r_sub - r_d), abs(n_sub - n_d))
    log(f"[serve] streaming eval recall@{k}={r_s:.4f} ndcg@{k}={n_s:.4f} "
        f"| first {n_dense} users: streaming {r_sub:.6f}/{n_sub:.6f}, "
        f"dense reference {r_d:.6f}/{n_d:.6f} (|delta| {delta:.2e})")
    out.update(store=store, memory=mem, stats=stats, results=results,
               users=users, k=k, recall=r_s, ndcg=n_s,
               dense_users=n_dense, recall_sub=r_sub, ndcg_sub=n_sub,
               recall_dense=r_d, ndcg_dense=n_d, dense_delta=delta)
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
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the kernels; cpu their plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced(get(args.arch)).model_cfg
    ds = reduced_dataset(cfg)
    params = kgnn.init_params(cfg, seed=0, device=dev)
    bits = None if args.bits == "fp32" else int(args.bits)
    serve_kgnn(cfg, ds, params, bits=bits, k=args.k,
               requests=args.requests, device=dev)


if __name__ == "__main__":
    main()
