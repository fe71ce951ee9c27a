#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and hold its kernels to
their plain versions.

    python3 chip_smoke.py

1. Prints the card's name and power limit as nvidia-smi reports them.
2. Builds the three kernels of the serving path from src/repro_torch/csrc
   for sm_90a (one nvcc per source, started together, while the full-width
   dataset is generated) and prints ptxas's register/spill report.
3. For each kernel, at the shapes the serving path gives it, compares the
   kernel with its plain PyTorch version on the same inputs on the card:
     quant_pack  codes, scale and zero bit-identical (70,679x256 and
                 24,915x256, bits 8 and 4, nearest and SR, odd widths);
     spmm        <= 1e-5 relative (max |diff| / max |plain|) on the
                 full-width KGAT graph, and bit-identical across two runs;
     topk_score  indices and values bit-identical on integer-valued inputs
                 full of ties; on random inputs values <= 1e-5 relative and
                 indices equal except between scores within that tolerance.
   and times kernel, plain version and (where one PyTorch call computes the
   same function) that call, as medians of CUDA-event timings, beside the
   bound: max(bytes / 3.35 TB/s, fp32 ops / 67 TFLOP/s), the H100 SXM's
   published peaks, with the bytes the function must move (each input
   read once, each output written once).
4. Cross-checks the reduced KGAT rollout on the card against the CPU.
5. Drives the main path at full width through ``serve_kgnn``: the paper's
   KGAT config (70,679 users, 113,487 entities, 80 relations, d 64, 3
   layers, concat readout) on the synthetic Amazon-Book-sized CKG, random
   seeded weights, FP32 rollout, INT8 store, engine warmup and a burst of
   requests, streaming eval over all users, dense reference on the first
   8,192 (streaming and dense within 1e-6). Launch counts are reset just
   before and read just after; every kernel must have launched.
6. Holds what the main path served against plain versions at full width:
   a second rollout with the kernels against one with the plain SPMM
   (<= 1e-5 relative), the served store against the plain quantizer on
   that rollout (bit-identical), and the engine's responses for a sample of
   users against the plain top-K on the served store (as in 3).
7. Prints the kernels JSON line, then last the ok line.

Exits non-zero, printing no result, without CUDA, outside a checkout of the
repository, or when any check fails.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TOL = 1e-5
DEV = "cuda"
# the paper's Amazon-Book-sized CKG (KGAT config: configs/kgnn_paper.py)
DATASET = dict(n_users=70679, n_items=24915, n_attrs=88572, n_relations=39,
               n_triples=2557746, inter_per_user=12, seed=0)
QUANT_ROWS = (70679, 24915)    # the store's user and item tables
TOPK_BATCH = (8, 128)          # an engine batch, an eval user chunk
REQUESTS = 400
DENSE_USERS = 8192
SERVED_USERS = 256           # engine responses held against plain top-K


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median per-call device time from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# -- kernels against their plain versions -------------------------------------


def check_quant_pack(torch, qp, gen):
    log("[quant_pack] kernel vs plain (codes, scale, zero bit-identical)")
    cases = [(r, 256, b, s) for r in QUANT_ROWS for b in (8, 4)
             for s in (False, True)]
    cases += [(QUANT_ROWS[1], 255, 4, True), (4096, 37, 2, False),
              (4096, 37, 1, True)]
    xs = {}
    for rows, d, bits, sr in cases:
        x = xs.get((rows, d))
        if x is None:
            x = xs[(rows, d)] = torch.randn((rows, d), generator=gen,
                                            device=DEV) * 0.3
        seed = 0x5EED + bits
        got = qp.quant_pack_cuda(x, seed, bits=bits, stochastic=sr)
        ref = qp.quant_pack_plain(x, seed, bits=bits, stochastic=sr)
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        log(f"  {rows}x{d} bits={bits} {'sr' if sr else 'nearest'}: "
            f"{'bit-identical' if same else 'MISMATCH'}")
        check(same, f"quant_pack {rows}x{d} bits={bits} sr={sr} differs")
    # timing: the main path's largest call (user table, INT8, nearest)
    rows, d, bits = QUANT_ROWS[0], 256, 8
    x = xs[(rows, d)]
    got = qp.quant_pack_cuda(x, 1, bits=bits, stochastic=False)
    ref = qp.quant_pack_plain(x, 1, bits=bits, stochastic=False)
    err = max(float((g.float() - r.float()).abs().max())
              for g, r in zip(got, ref))
    check(err == 0.0, f"quant_pack timed case differs by {err}")
    ms = time_ms(lambda: qp.quant_pack_cuda(x, 1, bits=bits,
                                            stochastic=False), 50)
    plain = time_ms(lambda: qp.quant_pack_plain(x, 1, bits=bits,
                                                stochastic=False), 10)
    n_bytes = rows * d * 4 + rows * d * bits // 8 + 8 * rows
    bnd, by = bound_ms(n_bytes, 7 * rows * d)
    log(f"  time {rows}x{d} int8: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {bnd:.4f} ms ({by})")
    return dict(name="quant_pack", route="cuda",
                source="src/repro_torch/csrc/quant_pack.cu",
                replaces="src/repro/kernels/quant_pack.py:39",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None,
                shape=f"{rows}x{d} bits 8 nearest")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check_spmm(torch, sp, g, x, gen):
    log("[spmm] kernel vs plain on the full-width KGAT graph")
    m = g.layout.meta
    ew = torch.rand(m.n_edges, generator=gen, device=DEV)
    out1 = sp.spmm_cuda(x, ew, g.layout)
    out2 = sp.spmm_cuda(x, ew, g.layout)
    ref = sp.spmm_plain(x, ew, g.layout)
    rel = _rel(out1, ref)
    err = float((out1 - ref).abs().max())
    same = torch.equal(out1, out2)
    log(f"  weighted: rel {rel:.3e} (max abs {err:.3e}), two runs "
        f"{'bit-identical' if same else 'DIFFER'}")
    check(rel <= TOL, f"spmm weighted rel error {rel} > {TOL}")
    check(same, "spmm is not deterministic across runs")
    rel1 = _rel(sp.spmm_cuda(x, None, g.layout),
                sp.spmm_plain(x, None, g.layout))
    gt = torch.randn((m.n_dst, x.shape[1]), generator=gen,
                     device=DEV) * 0.1
    rel_t = _rel(sp.spmm_cuda(gt, ew, g.layout, transpose=True),
                 sp.spmm_plain(gt, ew, g.layout, transpose=True))
    log(f"  unweighted: rel {rel1:.3e}; transpose direction: rel {rel_t:.3e}")
    check(rel1 <= TOL and rel_t <= TOL, "spmm unweighted/transpose error")

    ms = time_ms(lambda: sp.spmm_cuda(x, ew, g.layout), 20)
    plain = time_ms(lambda: sp.spmm_plain(x, ew, g.layout), 5)
    src, dst = g.src.long(), g.dst.long()
    with warnings.catch_warnings():      # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(torch.stack([dst, src]), ew,
                                    (m.n_dst, m.n_src)).coalesce()
        a = a.to_sparse_csr()
    lib_err = _rel(torch.sparse.mm(a, x), ref)
    check(lib_err <= TOL, f"library sparse.mm disagrees ({lib_err})")
    lib = time_ms(lambda: torch.sparse.mm(a, x), 20)
    d = x.shape[1]
    # the function's bytes: the table read once, a source index and a
    # weight per edge, CSR row pointers, the output written once
    n_bytes = (m.n_src * d * 4 + m.n_edges * 8 + (m.n_dst + 1) * 4
               + m.n_dst * d * 4)
    bnd, by = bound_ms(n_bytes, 2 * m.n_edges * d)
    log(f"  time E={m.n_edges} d={d}: kernel {ms:.4f} ms, plain {plain:.4f} "
        f"ms, torch.sparse.mm (CSR) {lib:.4f} ms, bound {bnd:.4f} ms ({by}; "
        f"{n_bytes / 1e9:.3f} GB); an uncached per-edge row gather would "
        f"move {m.n_edges * d * 4 / 1e9:.3f} GB")
    return dict(name="spmm", route="cuda",
                source="src/repro_torch/csrc/spmm.cu",
                replaces="src/repro/kernels/spmm.py:91",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib,
                shape=f"E={m.n_edges} n={m.n_dst} d={d} weighted")


def _topk_inputs(torch, quantize, gen, b, n_items, d, *, ties):
    if ties:
        from repro_torch.core.quant import QTensor, pack_bits

        codes = torch.randint(0, 4, (n_items, d), generator=gen,
                              device=DEV).to(torch.uint8)
        items = QTensor(pack_bits(codes, 8),
                        torch.ones((n_items, 1), device=DEV),
                        torch.zeros((n_items, 1), device=DEV), 8, d)
        q = torch.randint(-2, 3, (b, d), generator=gen,
                          device=DEV).to(torch.float32)
    else:
        items = quantize(torch.randn((n_items, d), generator=gen,
                                     device=DEV) * 0.3, 0, bits=8)
        q = torch.randn((b, d), generator=gen, device=DEV) * 0.3
    excl = torch.randint(0, n_items, (b, 12), generator=gen, device=DEV,
                         dtype=torch.int32)
    excl[:, 9:] = -1
    return q, items, excl


def check_topk(torch, tk, gen):
    from repro_torch.core.quant import dequantize, quantize

    n_items, d, k = DATASET["n_items"], 256, 20
    log(f"[topk_score] kernel vs plain, I={n_items} d={d} k={k}, "
        f"12 exclusions")
    entry = None
    for b in TOPK_BATCH:
        q, items, excl = _topk_inputs(torch, quantize, gen, b, n_items, d,
                                      ties=True)
        kv, ki = tk.topk_cuda(q, items, excl, k=k)
        pv, pi = tk.topk_plain(q, items, excl, k=k)
        same = torch.equal(ki, pi) and torch.equal(kv, pv)
        log(f"  B={b} integer-valued ties: "
            f"{'bit-identical' if same else 'MISMATCH'}")
        check(same, f"topk tie case B={b} differs")

        q, items, excl = _topk_inputs(torch, quantize, gen, b, n_items, d,
                                      ties=False)
        kv, ki = tk.topk_cuda(q, items, excl, k=k)
        pv, pi = tk.topk_plain(q, items, excl, k=k)
        xhat = dequantize(items)
        scale = float(pv.abs().max())
        err = float((kv - pv).abs().max())
        dense = q @ xhat.T
        picked = torch.gather(dense, 1, ki.long())
        swapped = ki != pi
        ok_idx = bool(((kv - pv).abs()[swapped] <= TOL * scale).all())
        ok_pick = float((picked - kv).abs().max()) <= TOL * scale
        hit = (ki[:, :, None] == excl[:, None, :]).any()
        log(f"  B={b} random: values rel {err / scale:.3e}, "
            f"{int(swapped.sum())} index swaps (near-ties), "
            f"excluded ids returned: {bool(hit)}")
        check(err <= TOL * scale and ok_idx and ok_pick and not bool(hit),
              f"topk random case B={b} out of tolerance")

        ms = time_ms(lambda: tk.topk_cuda(q, items, excl, k=k), 50)
        plain = time_ms(lambda: tk.topk_plain(q, items, excl, k=k), 5)
        lib = time_ms(lambda: torch.topk(q @ dequantize(items).T, k), 50)
        dp = items.packed.shape[1]
        n_bytes = (n_items * dp + 8 * n_items + b * d * 4 + excl.numel() * 4
                   + b * k * 8)
        bnd, by = bound_ms(n_bytes, 2 * b * n_items * d + 2 * n_items * d)
        log(f"  time B={b}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"torch.topk(q @ dequantize(items).T) {lib:.4f} ms, "
            f"bound {bnd:.4f} ms ({by})")
        entry = dict(name="topk_score", route="cuda",
                     source="src/repro_torch/csrc/topk_score.cu",
                     replaces="src/repro/kernels/topk_score.py:115",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                     bound_by=by, library_ms=lib,
                     shape=f"B={b} I={n_items} d={d} k={k} int8")
    return entry     # the B=128 shape: the streaming eval's calls


def check_reduced_rollout(torch):
    from repro_torch.configs import get
    from repro_torch.configs.smoke import reduced
    from repro_torch.launch.serve import reduced_dataset
    from repro_torch.models import kgnn

    cfg = reduced(get("kgat")).model_cfg
    ds = reduced_dataset(cfg)
    p_cpu = kgnn.init_params(cfg, seed=0, device="cpu")
    p_gpu = kgnn.init_params(cfg, seed=0, device=DEV)
    ref = kgnn.propagate(p_cpu, ds.graph("cpu"), cfg)
    got = kgnn.propagate(p_gpu, ds.graph(DEV), cfg).cpu()
    err = float((got - ref).abs().max())
    log(f"[rollout] reduced KGAT, card vs CPU plain versions: max abs "
        f"{err:.3e}")
    check(err <= TOL, f"reduced rollout differs from the CPU by {err}")


# -- the main path --------------------------------------------------------------


def run_main_path(torch, cfg, ds, g, params):
    from repro_torch.kernels import backend
    from repro_torch.launch.serve import serve_kgnn

    torch.cuda.reset_peak_memory_stats()
    backend.reset_counts()
    res = serve_kgnn(cfg, ds, params, bits=8, k=20, requests=REQUESTS,
                     device=DEV, graph=g, dense_users=DENSE_USERS, log=log)
    counts = dict(backend.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] LAUNCH_COUNTS {json.dumps(counts, sort_keys=True)}")
    for name, ph in res["phases"].items():
        log(f"[main] phase {name}: {ph['seconds']:.3f} s, launches "
            f"{json.dumps(ph['launches'], sort_keys=True)}")
    log(f"[main] torch.cuda.max_memory_allocated {peak} B "
        f"({peak / 2**30:.2f} GiB)")
    log(f"[main] engine {res['stats']}")
    for name in backend.SOURCES:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never launched on the main path")

    store = res["store"]
    width = (cfg.n_layers + 1) * cfg.dim            # concat readout
    check(store.users.packed.shape == (cfg.n_users, width)
          and store.items.packed.shape == (ds.n_items, width),
          "store shapes")
    for t in (store.users, store.items):
        check(bool(torch.isfinite(t.scale).all() and
                   torch.isfinite(t.zero).all()), "non-finite store rows")
    check(0.0 <= res["recall"] <= 1.0 and 0.0 <= res["ndcg"] <= 1.0,
          "metrics out of range")
    check(res["dense_delta"] <= 1e-6,
          f"streaming eval vs dense reference |delta| {res['dense_delta']}")
    return counts, res


@contextlib.contextmanager
def plain_versions(ops, **plain):
    """Route ``ops.<name>`` to the given plain version, CUDA tensors
    included (the reference runs of this script only)."""
    saved = {n: getattr(ops, n) for n in plain}
    try:
        for n, fn in plain.items():
            setattr(ops, n, fn)
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def check_served_path(torch, cfg, ds, g, params, res):
    """Hold what the main path served against plain versions at full width:
    the rollout, the packed store, and the engine's top-K responses."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import spmm as sp
    from repro_torch.kernels import topk_score as tk
    from repro_torch.models import kgnn
    from repro_torch.serving.store import (QuantizedEmbeddingStore,
                                           padded_pos_lists)

    reps = kgnn.propagate(params, g, cfg)
    with plain_versions(ops, spmm=sp.spmm_plain):
        reps_plain = kgnn.propagate(params, g, cfg)
    rel = _rel(reps, reps_plain)
    log(f"[served] full-width rollout, kernels vs plain SPMM: rel {rel:.3e}")
    check(rel <= TOL, f"full-width rollout differs from plain by {rel}")

    store = res["store"]
    n_u = cfg.n_users
    with plain_versions(ops, quant_pack=qp.quant_pack_plain):
        ref = QuantizedEmbeddingStore.from_arrays(
            reps[:n_u], reps[n_u:n_u + ds.n_items], bits=store.bits)
    same = all(torch.equal(a, b) for s_t, r_t in
               ((store.users, ref.users), (store.items, ref.items))
               for a, b in ((s_t.packed, r_t.packed), (s_t.scale, r_t.scale),
                            (s_t.zero, r_t.zero)))
    log(f"[served] store vs plain quant_pack of a second rollout: "
        f"{'bit-identical' if same else 'MISMATCH'}")
    check(same, "served store is not the plain packing of the rollout")

    n = SERVED_USERS
    users = res["users"][:n]
    ids = torch.from_numpy(users).to(DEV)
    excl = torch.from_numpy(padded_pos_lists(ds.train_pos, ds.n_users))
    excl = excl.to(DEV)[ids]
    pv, pi = tk.topk_plain(store.user_vectors(ids), store.items, excl,
                           k=res["k"])
    ev = torch.from_numpy(np.stack([r[0] for r in res["results"][:n]]))
    ei = torch.from_numpy(np.stack([r[1] for r in res["results"][:n]]))
    ev, ei = ev.to(DEV), ei.to(DEV)
    scale = float(pv.abs().max())
    err = float((ev - pv).abs().max())
    swapped = ei != pi
    near = bool(((ev - pv).abs()[swapped] <= TOL * scale).all())
    hit = bool((ei[:, :, None] == excl[:, None, :]).any())
    log(f"[served] engine responses for {n} users vs plain top-K on the "
        f"served store: values rel {err / scale:.3e}, "
        f"{int(swapped.sum())} index swaps (near-ties), excluded ids "
        f"returned: {hit}")
    check(err <= TOL * scale and near and not hit,
          "engine responses differ from the plain top-K")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")

    from repro_torch.configs import get
    from repro_torch.data.synthetic import gen_kg_dataset
    from repro_torch.kernels import backend
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import spmm as sp
    from repro_torch.kernels import topk_score as tk
    from repro_torch.models import kgnn

    torch.backends.cuda.matmul.allow_tf32 = False
    info = backend.probe()
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {info.name} sm_{info.capability[0]}{info.capability[1]} "
        f"count {info.count}")
    backend.require_sm90(torch.device("cuda", 0))

    with ThreadPoolExecutor(max_workers=1) as pool:
        t0 = time.perf_counter()
        build = pool.submit(backend.build)
        cfg = get("kgat").model_cfg
        ds = gen_kg_dataset(**DATASET)
        log(f"[data] CKG: {ds.n_nodes} nodes, {len(ds.src)} edges, "
            f"{ds.n_relations} relations, {len(ds.train_pos)} train / "
            f"{len(ds.test_pos)} test pairs "
            f"({time.perf_counter() - t0:.1f} s)")
        check(ds.n_nodes == cfg.n_nodes and ds.n_relations == cfg.n_relations
              and ds.n_users == cfg.n_users, "dataset does not fit the config")
        logs = build.result()
    log(f"[build] nvcc {' '.join(backend.NVCC_FLAGS)} "
        f"({time.perf_counter() - t0:.1f} s incl. data)")
    for name, text in logs.items():
        log(f"  {name}: src/repro_torch/csrc/{name}.cu -> "
            f"{backend.lib_path(name).relative_to(root)} "
            f"({'compiled now' if text else 'already built'})")
        for line in text.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line
                                         or "spill" in line):
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    g = ds.graph(DEV)
    m = g.layout.meta
    log(f"[data] layout: {m.n_blocks} blocks x {m.block_e} slots, "
        f"{m.n_tiles} tiles ({time.perf_counter() - t0:.1f} s)")
    params = kgnn.init_params(cfg, seed=0, device=DEV)

    gen = torch.Generator(device=DEV).manual_seed(0)
    entries = [check_quant_pack(torch, qp, gen),
               check_spmm(torch, sp, g, params["entity"], gen),
               check_topk(torch, tk, gen)]
    check_reduced_rollout(torch)

    counts, res = run_main_path(torch, cfg, ds, g, params)
    check_served_path(torch, cfg, ds, g, params, res)
    for e in entries:
        e["launches"] = counts[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
