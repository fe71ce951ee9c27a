"""Serving launcher (port of the kgnn and recsys paths of
``repro/launch/serve.py`` and of ``examples/serve_recsys.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch kgat --bits 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch kgat --bits 8 \\
      --two-stage 4 --item-shards 2 --cache 64 --refresh-steps 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch kgat --bits 4 \\
      --requests 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-mlperf \\
      --batch 512 --requests 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xdeepfm \\
      --retrieval 1000 --k 32 --requests 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-12b \\
      --batch 4 --tokens 16 --device cpu

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

``--trace OUT.json`` writes a Chrome-trace/Perfetto JSON of the host spans
(``serve/batch`` drains and the engine's stages), ``--metrics-out DIR`` the
schema-validated ``summary.json`` of the metrics registry
(``serve/latency_ms``, queue depth, stage times, cache hits), which
``main`` empties first so that the summary holds this run's series alone.

``serve_kgnn`` is the same path as a function, so that a caller can drive it
at any size (``chip_smoke.py`` runs it at full width).

The recsys archs (fm, wide-deep, dlrm-mlperf, xdeepfm) score batches with
the full model (``serve_recsys``, the reference's path: warm once, then
``--requests`` batches of ``--batch``, p50/p99). ``--retrieval N`` runs the
two-stage path of the reference's ``examples/serve_recsys.py`` instead
(``serve_recsys_two_stage``): the two towers (``recsys.retrieval_towers``)
over the first N ids of field 0, the item tower packed at
``--bits`` into a ``QuantizedEmbeddingStore`` (the query tower stays
fp32), micro-batched top-``--k`` through the ``ServingEngine`` (the top-K
kernel on the card), recall against a dense fp32 top-K of the same towers,
then a re-rank of each top-K with the full model's ``forward``. Random
seed-0 parameters; on the CPU the reduced config, on the card the full one
(``--row-cap N`` caps each table, which DLRM's 96.1 GB table needs: a
table that does not fit is refused with its bytes).

The LM archs serve greedy generation (``serve_lm``, the reference's path):
random seed-0 parameters, a seeded numpy prompt of 16 tokens a sequence,
``prefill`` into the KV cache, then ``--tokens`` - 1 greedy
``decode_step``s of ``--batch`` sequences; it prints the prefill's ms and
the decode's ms a token. On the CPU the reduced config; on the card the
published widths in bfloat16 at 2 layers (``models.registry.lm_config``).
The int8 cache is the config's ``kv_cache_bits=8``
(``dataclasses.replace``), as the reference's tests reach it.
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
from repro_torch.obs import get_tracer, log as obs_log, reset_registry, \
    write_summary
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.eval import streaming_eval_dataset, \
    streaming_recall_ndcg
from repro_torch.serving.store import QuantizedEmbeddingStore, \
    build_kgnn_store, padded_pos_lists
from repro_torch.training.metrics import recall_ndcg_at_k
from repro_torch.training.optimizer import adam
from repro_torch.training.step import trainable

__all__ = ["serve_kgnn", "serve_recsys", "serve_recsys_two_stage",
           "serve_lm", "bpr_trainer", "reduced_dataset", "main"]

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


def serve_lm(cfg, params, *, batch: int, tokens: int, prompt_len: int = 16,
             device="cuda", name: str = "lm", log=print) -> dict:
    """Greedy generation (port of the reference's ``serve_lm``): a
    ``(batch, prompt_len)`` prompt from ``numpy.random.default_rng(1)``,
    ``prefill`` into a cache of ``prompt_len + tokens`` positions, then
    ``tokens - 1`` ``decode_step``s, each feeding the last step's argmax.
    Returns the prefill's ms, the decode's ms a step, the generated tokens
    ``(batch, tokens)`` and the cache's bytes."""
    from repro_torch.models import transformer as tf

    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))
                              ).to(dev)
    cache = tf.init_cache(cfg, batch, prompt_len + tokens, dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, prompt, cfg, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    toks = torch.argmax(logits, -1)[:, None]
    out = [toks]
    t0 = time.perf_counter()
    for _ in range(tokens - 1):
        logits, cache = tf.decode_step(params, cache, toks, cfg)
        toks = torch.argmax(logits, -1)[:, None]
        out.append(toks)
    _sync(dev)
    dt = time.perf_counter() - t0
    per = dt / max(tokens - 1, 1)
    seq = torch.cat(out, 1)
    log(f"[serve] {name}: prefill({batch}x{prompt_len}) "
        f"{t_prefill * 1e3:.1f}ms | {tokens - 1} decode steps "
        f"{dt * 1e3:.1f}ms ({per * 1e3:.2f} ms/tok/batch)")
    log(f"[serve] sample tokens: {seq[0, :12].cpu().numpy()}")
    return {"prefill_ms": t_prefill * 1e3, "ms_per_token": per * 1e3,
            "tokens": seq, "cache_bytes": tf.cache_bytes(cache)}


def _recsys_queries(cfg, n: int, rng):
    """(n, F) int32 field-local ids, field f drawn uniformly from ``[0,
    vocab_f)`` (the reference draws every field from ``[0, min vocab)``,
    which at full width is ids 0-2 of each field)."""
    return rng.integers(0, np.asarray(cfg.vocab_sizes),
                        (n, cfg.n_sparse)).astype(np.int32)


def _percentiles(lat_ms) -> tuple[float, float]:
    """The reference's p50 and p99 of a list of latencies."""
    lat = np.sort(np.asarray(lat_ms))
    return float(lat[len(lat) // 2]), float(lat[-max(len(lat) // 100, 1)])


def serve_recsys(cfg, params, *, batch: int, requests: int, device="cuda",
                 name: str | None = None, log=print) -> dict:
    """Batched CTR scoring with the full model (port of
    ``repro/launch/serve.py:serve_recsys``): one warm-up batch, then
    ``requests`` batches of ``batch`` (``_recsys_queries`` ids and normal
    dense features from seed 0, on the device before the clock starts),
    each timed from the call to its logits on the host's side of a
    synchronize. Returns the latencies, p50/p99 and the kernel launches of
    the timed batches."""
    from repro_torch.models import recsys

    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def request(n):
        return {"sparse": torch.from_numpy(_recsys_queries(
                    cfg, n, rng)).to(dev),
                "dense": torch.from_numpy(rng.normal(
                    size=(n, max(cfg.n_dense, 1))).astype(np.float32)
                    ).to(dev)}

    @torch.no_grad()
    def score(b):
        out = recsys.forward(params, b, cfg)
        _sync(dev)
        return out

    score(request(batch))
    lat, c0 = [], _counts()
    for _ in range(requests):
        b = request(batch)
        _sync(dev)
        t0 = time.perf_counter()
        score(b)
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p99 = _percentiles(lat)
    log(f"[serve] {name or cfg.model}: batch={batch} p50={p50:.2f}ms "
        f"p99={p99:.2f}ms")
    return {"latencies_ms": lat, "p50_ms": p50, "p99_ms": p99,
            "launches": _diff(_counts(), c0)}


def serve_recsys_two_stage(cfg, params, *, n_cand: int, k: int = 32,
                           requests: int = 200, bits: int | None = 8,
                           item_field: int = 0, device="cuda",
                           name: str | None = None, log=print) -> dict:
    """Two-stage recsys serving (port of ``examples/serve_recsys.py``):
    retrieval through the engine over the packed item tower, then a
    re-rank of each request's top-``k`` with the full ``forward``.

    ``requests`` queries (``_recsys_queries`` from seed 0) are the store's
    users, one row each; the candidates are ids ``0 .. n_cand-1`` of field
    ``item_field``; the engine's buckets are the reference example's (1, 4, 16,
    64). Returns the store and its memory report, the engine's stats, the
    retrieved ids and values, ``recall`` (the mean share of the dense fp32
    top-``k`` of the same towers that the engine returned), the re-rank's
    latencies and p50/p99, and per phase the kernel launches and wall time."""
    from repro_torch.models import recsys

    dev = resolve_device(device)
    queries = _recsys_queries(cfg, requests, np.random.default_rng(0))
    out: dict = {"phases": {}}

    def phase(key, fn):
        c0 = _counts()
        _sync(dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        out["phases"][key] = {"seconds": time.perf_counter() - t0,
                              "launches": _diff(_counts(), c0)}
        return res

    q_dev = torch.from_numpy(queries).to(dev)
    cand = torch.arange(n_cand, device=dev)
    with torch.no_grad():
        user_aug, cand_aug = phase("towers", lambda: recsys.retrieval_towers(
            params, q_dev, cand, cfg, item_field=item_field))
    # only the item tower is packed: a query vector is made per request
    store = phase("pack", lambda: QuantizedEmbeddingStore.from_arrays(
        user_aug, cand_aug, bits=bits, quantize_users=False))
    mem = store.memory_report()
    with ServingEngine(store, k=k, buckets=(1, 4, 16, 64)) as eng:
        phase("warmup", eng.warmup)

        def burst():
            futs = [eng.submit(i) for i in range(requests)]
            return [f.result(timeout=300) for f in futs]

        retrieved = phase("engine", burst)
        stats = eng.stats()
    got = np.stack([idx for _, idx in retrieved])               # (R, k)
    got_v = np.stack([v for v, _ in retrieved])

    def dense_topk():
        ids = []
        for a in range(0, requests, 64):
            s = user_aug[a:a + 64] @ cand_aug.T
            ids.append(torch.topk(s, k, dim=1).indices.cpu().numpy())
        return np.concatenate(ids)

    ref = phase("dense_reference", dense_topk)
    recall = float(np.mean([len(np.intersect1d(g, r)) / k
                            for g, r in zip(got, ref)]))

    dense = torch.zeros((k, max(cfg.n_dense, 1)), device=dev)

    def rerank_batch(r):
        sparse = np.repeat(queries[r:r + 1], k, 0)
        sparse[:, item_field] = got[r]
        return {"sparse": torch.from_numpy(sparse).to(dev), "dense": dense}

    @torch.no_grad()
    def rerank(b):
        s = recsys.forward(params, b, cfg)
        _sync(dev)
        return s

    rerank(rerank_batch(0))                                     # warm
    lat, best = [], []

    def rerank_all():
        for r in range(requests):
            b = rerank_batch(r)
            _sync(dev)
            t0 = time.perf_counter()
            s = rerank(b)
            lat.append((time.perf_counter() - t0) * 1e3)
            best.append(int(got[r][int(torch.argmax(s))]))

    phase("rerank", rerank_all)
    p50, p99 = _percentiles(lat)
    log(f"[serve] {name or cfg.model} retrieval: {n_cand} candidates of "
        f"field {item_field}, d {cfg.embed_dim + 1}, bits={bits or 'fp32'} "
        f"{mem['total_bytes']} B ({mem['compression_ratio']:.2f}x vs fp32)"
        f"; engine {stats}; recall@{k} {recall:.4f} against the dense fp32 "
        f"top-{k} of the same towers")
    log(f"[serve] {name or cfg.model} re-rank: batch={k} p50 {p50:.2f}ms "
        f"p99 {p99:.2f}ms; request 0's winner: candidate {best[0]}")
    out.update(memory=mem, stats=stats, retrieved=got,
               retrieved_values=got_v, reference=ref,
               recall=recall, rerank_ms=lat, rerank_p50_ms=p50,
               rerank_p99_ms=p99, best=best, store=store)
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
    ap.add_argument("--batch", type=int, default=4,
                    help="recsys: examples a scored batch; lm: sequences")
    ap.add_argument("--tokens", type=int, default=16,
                    help="lm: tokens generated a sequence")
    ap.add_argument("--retrieval", type=int, default=None, metavar="N",
                    help="recsys: two-stage serving over N candidates "
                         "(packed retrieval, then a full-model re-rank)")
    ap.add_argument("--row-cap", type=int, default=None, metavar="N",
                    help="recsys: cap each embedding table at N rows")
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
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome-trace/Perfetto JSON of the host "
                         "spans (serve/batch drains etc.)")
    ap.add_argument("--metrics-out", default=None, metavar="DIR",
                    help="write the schema-validated summary.json registry "
                         "snapshot (serve/latency_ms, queue depth, ...) "
                         "under DIR")
    args = ap.parse_args(argv)
    family = get(args.arch).family
    if family not in ("kgnn", "recsys", "lm", "moe_lm"):
        raise SystemExit(f"{family} has no serve path "
                         "(GNNs are training workloads)")
    dev = resolve_device(args.device)
    reset_registry()   # the summary holds this run's series alone
    if args.trace:
        get_tracer().enable()
    try:
        bits = None if args.bits == "fp32" else int(args.bits)
        if family == "recsys":
            _serve_recsys_main(args, dev, bits)
        elif family in ("lm", "moe_lm"):
            _serve_lm_main(args, dev)
        else:
            cfg = reduced(get(args.arch)).model_cfg
            ds = reduced_dataset(cfg)
            params = kgnn.init_params(cfg, seed=0, device=dev)
            serve_kgnn(cfg, ds, params, bits=bits, k=args.k,
                       requests=args.requests, device=dev,
                       train_steps=args.train_steps,
                       two_stage=args.two_stage,
                       item_shards=args.item_shards, cache=args.cache,
                       max_pending=args.max_pending,
                       refresh_steps=args.refresh_steps)
        run = {"kind": "serve", "arch": args.arch, "family": family,
               "requests": args.requests, "bits": args.bits}
        if args.trace:
            obs_log(f"[serve] trace written to "
                    f"{get_tracer().save(args.trace, run=run)}")
        if args.metrics_out:
            obs_log(f"[serve] metrics summary written to "
                    f"{write_summary(args.metrics_out, run)}")
    finally:
        get_tracer().disable()


def _serve_lm_main(args, dev: torch.device) -> None:
    """The launcher's LM path: the reduced config on the CPU, the published
    widths at 2 layers on the card, seed-0 parameters."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import lm_config

    cfg = (reduced(get(args.arch)).model_cfg if dev.type == "cpu"
           else lm_config(args.arch))
    params = tf.init_params(cfg, seed=0, device=dev)
    serve_lm(cfg, params, batch=args.batch, tokens=args.tokens, device=dev,
             name=args.arch)


def _serve_recsys_main(args, dev: torch.device, bits: int | None) -> None:
    """The launcher's recsys path: the reduced config on the CPU, the full
    one (``--row-cap``) on the card, seed-0 parameters."""
    from repro_torch.models import recsys
    from repro_torch.models.registry import check_fits, recsys_config

    spec = get(args.arch)
    cfg = recsys_config(args.arch, row_cap=args.row_cap, cfg=(
        reduced(spec).model_cfg if dev.type == "cpu" else None))
    try:
        check_fits(cfg, dev, copies=1, name=args.arch)
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    params = recsys.init_params(cfg, seed=0, device=dev)
    if args.retrieval:
        serve_recsys_two_stage(cfg, params, n_cand=min(
            args.retrieval, cfg.vocab_sizes[0]), k=args.k,
            requests=args.requests, bits=bits, device=dev, name=args.arch)
    else:
        serve_recsys(cfg, params, batch=args.batch, requests=args.requests,
                     device=dev, name=args.arch)


if __name__ == "__main__":
    main()
