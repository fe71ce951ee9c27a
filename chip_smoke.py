#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and hold its kernels to
their plain versions.

    python3 chip_smoke.py

1. Prints the card's name and power limit as nvidia-smi reports them.
2. Builds the kernels of the serving and training paths from
   src/repro_torch/csrc for sm_90a (one nvcc per source, started together,
   while the full-width dataset is generated) and prints ptxas's
   register/spill report.
3. For each kernel, at the shapes its path gives it, compares the kernel
   with its plain PyTorch version on the same inputs on the card:
     quant_pack  codes, scale and zero bit-identical (70,679x256 and
                 24,915x256, bits 8 and 4, nearest and SR, odd widths);
     spmm        <= 1e-5 relative (max |diff| / max |plain|) on the
                 full-width KGAT graph at the main path's three shapes (d 64,
                 d 64 in the transpose direction, d 1: the edge softmax's
                 ones column), and bit-identical across two runs;
     topk_score  indices and values bit-identical on integer-valued inputs
                 full of ties; on random inputs values <= 1e-5 relative and
                 indices equal except between scores within that tolerance;
                 at B 1, 8 and 128 (k 20), and both again at k 200 (the
                 merge-rounds route);
     sddmm       <= 1e-5 relative on the full-width graph at d 64 (the
                 FP32 layers' gradient) and d 1 (the edge softmax's ones
                 column) and bit-identical across two runs;
     dequant_sddmm  the same at bits 8/4/2/1 (d 64) and on a padded pack
                 (d 37, bits 2); timed at INT2 and INT8, d 64;
     dequant_matmul <= 1e-5 relative at R 184,166, 64 x 64, bits 8/4/2/1,
                 and a padded pack (d 37), bit-identical across two runs;
     coarse_topm values and indices bit-identical at I 24,915, d 256, INT8
                 and INT4, on ties and random inputs, at B 1, 8 and 128
                 with m 80 and at B 8 with m = n_items, and on a tier-2
                 shard's table (12,458 items, B 8, m 80);
     dequant_unpack bit-identical on the item table (INT8, INT4), the
                 re-rank's 640 candidate rows, bits 2/1 and padded packs;
   and times kernel, plain version and (where one PyTorch call computes the
   same function) that call, as medians of CUDA-event timings (which read
   the host's pace where a call's launches outlast its device work), beside
   the bound: max(bytes / 3.35 TB/s, ops / peak), the H100 SXM's published
   peaks, with the bytes the function must move (each input read once,
   each output written once). The peak is the fp32 rate outside the tensor
   cores (67 TFLOP/s), except for coarse_topm: its dot multiplies int8
   query codes by unsigned codes and is exact at the int8 tensor-core rate
   (1,979 TOP/s). For topk_score and coarse_topm it also prints the device
   time of the kernel and of the library call (20 calls queued while a
   spinning kernel holds the stream, then run back to back between two CUDA
   events: no host gaps) and the CUDA kernels one wrapper call launches
   (read from torch.profiler, held to the kernel's own plan, at most 2 at
   k <= 128; a call whose kernels the profiler does not see fails). For
   top-K at B 1, 2 and 4 it also prints the device time at each query tile
   (8, 16, 32), the results bit-identical.
4. Cross-checks the reduced KGAT rollout on the card against the CPU.
5. Drives the main path at full width through ``serve_kgnn``: the paper's
   KGAT config (70,679 users, 113,487 entities, 80 relations, d 64, 3
   layers, concat readout) on the synthetic Amazon-Book-sized CKG, random
   seeded weights, FP32 rollout, INT8 store, engine warmup and a burst of
   requests, streaming eval over all users, dense reference on the first
   8,192 (streaming and dense within 1e-6), the eval's time printed.
   Launch counts are reset just
   before and read just after; every kernel must have launched.
6. Holds what the main path served against plain versions at full width:
   a second rollout with the kernels against one with the plain SPMM
   (<= 1e-5 relative), the served store against the plain quantizer on
   that rollout (bit-identical), and the engine's responses for a sample of
   users against the plain top-K on the served store (as in 3).
7. Drives the tier-2 serving path at full width through ``serve_kgnn``
   (counts reset just before, read just after; every kernel of the path
   must have launched): two-stage C 4, 2 item shards, a 4,096-entry cache,
   400 zipfian requests (a 1.1, seed 0), 2 FP32 BPR steps, a re-roll and a
   delta refresh, a second burst. Prints QPS and p50/p99 beside a
   single-stage engine's on the same requests, the stage times, the
   candidate share and the cache hit rate. Checks the live store against
   the new rollout (bit-identical) and every cache hit: its stamp is the
   live version and it agrees with a fresh score (as in 3). Holds the
   coarse kernel to its plain version on the served store's two shard
   tables (12,457 and 12,458 items) with the burst's users and exclusions
   at batch 1/2/4/8 and m 80 (bit-identical), and the first burst's
   responses for 256 users to two-stage retrieval run on the plain
   versions per shard and merged on the host (as in 3). Then prints
   two-stage recall@20 against single stage on all users (both phases'
   times printed) and holds the
   m = n_items anchor on 256 users to the single-stage kernel (indices
   equal except between scores within 1e-5 relative).
8. Drives the training path at full width through ``train_kgnn``: the same
   config and graph, BPR batch 1024, Adam, seed-0 parameters, a few steps
   each under FP32, INT8, INT4 and INT2 (stochastic rounding). Launch
   counts are reset just before and read just after each schedule's run;
   every kernel of its path must have launched. Prints per schedule the
   losses (finite), the median step time, peak allocated memory, the ACT
   bytes of the recorded residuals and their ratio to FP32, and launches
   per step by kernel.
9. Profiles one INT2 training step (torch.profiler, CUDA activity): device
   time by kernel, the step's device busy time and idle share.
10. One full-width step's gradients with the kernels against the same step
   with every kernel's plain version, from the same seeds, parameters and
   batch. FP32: both against the same step run in float64; per parameter
   the kernels' error (rms of the difference over the rms of the float64
   gradient) must be within four times the plain versions' error, or within
   1e-5 (readings 1.1-1.9 on correct kernels). Summation orders differ between the two and the backward cancels
   terms, so each is off float64 by up to about 1e-3 of max |grad|
   (printed beside the rms), and which of the two lands nearer float64 for
   one parameter is chance: the margin stands between that spread and a
   wrong kernel. INT2: max |kernels - plain| within 1e-2 of that
   parameter's SR quantization noise, max |INT2 grad - FP32 grad|
   (readings up to 8.4e-4 on correct kernels; an SR code can flip
   between the two runs where the SPMM's summation order moves a
   quantization input across a rounding threshold; one flip moves a
   gradient by one rounding step of one residual element, the noise sums
   such steps over every element).
11. Prints the kernels JSON line (launches per path: serve, serve_tier2,
    train_<schedule>), the card's line, then last the ok line.

Exits non-zero, printing no result, without CUDA, outside a checkout of the
repository, or when any check fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
INT8_OPS = 1979e12             # H100 SXM dense int8 tensor-core rate
TOL = 1e-5
DEV = "cuda"
# the paper's Amazon-Book-sized CKG (KGAT config: configs/kgnn_paper.py)
DATASET = dict(n_users=70679, n_items=24915, n_attrs=88572, n_relations=39,
               n_triples=2557746, inter_per_user=12, seed=0)
QUANT_ROWS = (70679, 24915)    # the store's user and item tables
SERVING = ("quant_pack", "spmm", "topk_score")
TIER2_KERNELS = SERVING + ("coarse_topm", "dequant_unpack", "sddmm")
TRAIN_BATCH = 1024
TRAIN_STEPS = 4              # per schedule
SCHEDULES = ("fp32", "int8", "int4", "int2")
GRAD_FP64_RATIO = 4.0
GRAD_NOISE_SHARE = 1e-2
ENGINE_BATCH = 8               # the engine's largest bucket
EVAL_BATCH = 128               # the streaming eval's user chunk
TOPK_BATCH = (1, ENGINE_BATCH, EVAL_BATCH)
LARGE_K = 200                  # past the threshold route's 128: merge rounds
COARSE_BATCH = TOPK_BATCH
COARSE_M = 4 * 20              # two-stage C 4 at k 20
SHARD_ITEMS = 12458            # the larger of the tier-2 path's two shards
QUERY_TILES = (8, 16, 32)      # csrc/topk_select.cuh kQTiles
TIER2 = dict(two_stage=4, item_shards=2, cache=4096, refresh_steps=2)
ZIPF_A = 1.1
ANCHOR_USERS = 256
PROFILED_BATCHES = 20
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


def bound_ms(n_bytes: float, n_ops: float,
             peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / peak * 1e3
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


def _spmm_library(torch, g, ew, transpose):
    """cuSPARSE's operand: the graph's coalesced CSR (A, or Aᵀ for the
    transpose direction) with the edge weights as values."""
    m = g.layout.meta
    src, dst = g.src.long(), g.dst.long()
    idx, shape = ((torch.stack([src, dst]), (m.n_src, m.n_dst)) if transpose
                  else (torch.stack([dst, src]), (m.n_dst, m.n_src)))
    with warnings.catch_warnings():      # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(idx, ew, shape).coalesce() \
            .to_sparse_csr()


def check_spmm(torch, sp, g, x, gen):
    """The main path's three SPMM shapes on the full-width graph: a layer's
    aggregation (d 64), its input gradient (d 64, transpose direction) and
    the edge softmax's denominators (a ones column, d 1)."""
    log("[spmm] kernel vs plain on the full-width KGAT graph")
    m = g.layout.meta
    ew = torch.rand(m.n_edges, generator=gen, device=DEV)
    rel1 = _rel(sp.spmm_cuda(x, None, g.layout),
                sp.spmm_plain(x, None, g.layout))
    log(f"  d={x.shape[1]} unweighted: rel {rel1:.3e}")
    check(rel1 <= TOL, f"spmm unweighted rel error {rel1} > {TOL}")
    gt = torch.randn((m.n_dst, x.shape[1]), generator=gen,
                     device=DEV) * 0.1
    ones = torch.ones((m.n_src, 1), device=DEV)
    entries = []
    for xin, tr in ((x, False), (gt, True), (ones, False)):
        d = xin.shape[1]
        label = f"d={d}{' transpose' if tr else ''}"
        out1 = sp.spmm_cuda(xin, ew, g.layout, transpose=tr)
        same = torch.equal(out1, sp.spmm_cuda(xin, ew, g.layout,
                                              transpose=tr))
        ref = sp.spmm_plain(xin, ew, g.layout, transpose=tr)
        rel, err = _rel(out1, ref), float((out1 - ref).abs().max())
        log(f"  {label} weighted: rel {rel:.3e} (max abs {err:.3e}), two "
            f"runs {'bit-identical' if same else 'DIFFER'}")
        check(rel <= TOL, f"spmm {label} rel error {rel} > {TOL}")
        check(same, f"spmm {label} is not deterministic across runs")
        a = _spmm_library(torch, g, ew, tr)
        lib_err = _rel(torch.sparse.mm(a, xin), ref)
        check(lib_err <= TOL, f"library sparse.mm disagrees ({lib_err})")
        ms = time_ms(lambda: sp.spmm_cuda(xin, ew, g.layout, transpose=tr),
                     20)
        plain = time_ms(lambda: sp.spmm_plain(xin, ew, g.layout,
                                              transpose=tr), 5)
        lib = time_ms(lambda: torch.sparse.mm(a, xin), 20)
        n_out = out1.shape[0]
        # the function's bytes: the table read once, a source index and a
        # weight per edge, CSR row pointers, the output written once
        n_bytes = (xin.shape[0] * d * 4 + m.n_edges * 8 + (n_out + 1) * 4
                   + n_out * d * 4)
        log(f"  {label}: an uncached per-edge row gather would move "
            f"{m.n_edges * d * 4 / 1e9:.3f} GB")
        entries.append(_entry(
            "spmm", "spmm", "src/repro/kernels/spmm.py:91", err, ms, plain,
            lib, n_bytes, 2 * m.n_edges * d,
            f"E={m.n_edges} n={n_out} {label} weighted",
            also_replaces="src/repro/kernels/spmm.py:180",
            library_call="torch.sparse.mm (CSR)"))
    return _with_other_shape(*entries)


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


def kernels_per_call(torch, fn, reads: int = 3):
    """CUDA kernels one call of ``fn`` launches, read from torch.profiler:
    the most of ``reads`` profiled calls (the profiler can lose a device
    event, never add one); fails where it sees none of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(reads):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and ("scan_kernel" in e.name
                               or "merge_" in e.name)))
    check(max(counts) > 0, "torch.profiler recorded no scan or merge kernel "
          "of the call: its launches cannot be counted")
    return max(counts)


def device_ms(torch, fn, calls: int = 20) -> float:
    """Device time per call of ``fn`` without the host's launch gaps: the
    stream is held by a spinning kernel while the host queues ``calls``
    calls, so they run back to back between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    spin = int(1e8)                       # about 50 ms of the card's clock
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        t0 = time.perf_counter()
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        if queued < 0.02:                 # queued well inside the spin
            return a.elapsed_time(b) / calls
        spin *= 4
    raise CheckFailed(f"could not queue {calls} calls inside the spin")


def _device_times(torch, kernel, library, label):
    """Log and return the device time per call of a kernel and its
    library call."""
    k, lib = device_ms(torch, kernel), device_ms(torch, library)
    log(f"  device time {label}: kernel {k:.4f} ms, library {lib:.4f} ms "
        f"(20 calls queued behind a held stream, CUDA events)")
    return dict(device_ms=k, library_device_ms=lib)


def _count_kernels(torch, tk, fn, b, items, m, coarse):
    """Print and check the CUDA kernels a wrapper call launches, as the
    profiler counts them."""
    p = tk.plan_for(b, items, m, device=DEV, coarse=coarse)
    note = (f"{p.route} route, query tile {p.qt}, {p.grid} CTAs, "
            f"{p.slots} lists of {p.list_len} a row")
    n = kernels_per_call(torch, fn)
    log(f"  B={b} I={items.rows} m={m}: {note}; CUDA kernels per call {n} "
        f"(plan {p.n_kernels})")
    check(n == p.n_kernels,
          f"{n} CUDA kernels a call against the plan's {p.n_kernels}")
    check(m > 128 or n <= 2, f"{n} CUDA kernels a call at m {m} <= 128")
    return n


def _tile_sweep(torch, tk, quantize, gen, n_items, d, k):
    """Device time of top-K at the engine's small buckets at every query
    tile the kernels have (padded rows cost FMAs): the results
    bit-identical, the plan's tile the smallest."""
    for b in (1, 2, 4):
        q, items, excl = _topk_inputs(torch, quantize, gen, b, n_items, d,
                                      ties=False)
        ref = tk.topk_cuda(q, items, excl, k=k)
        times = []
        for qt in QUERY_TILES:
            got = tk._topk_cuda(q, items, excl, k, qt)
            check(all(torch.equal(x, y) for x, y in zip(got, ref)),
                  f"topk B={b} at query tile {qt} differs")
            t = device_ms(torch, lambda: tk._topk_cuda(q, items, excl, k, qt))
            times.append(f"{t:.4f} ms at tile {qt}")
        log(f"  tile sweep B={b} (plan: tile "
            f"{tk.plan_for(b, items, k, device=DEV).qt}): device "
            + ", ".join(times) + " (bit-identical)")


def check_topk(torch, tk, gen):
    from repro_torch.core.quant import dequantize, quantize

    n_items, d, k = DATASET["n_items"], 256, 20
    log(f"[topk_score] kernel vs plain, I={n_items} d={d} k={k}, "
        f"12 exclusions")
    entries = []
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

        n_k = _count_kernels(torch, tk, lambda: tk.topk_cuda(q, items, excl,
                                                             k=k),
                             b, items, k, False)
        ms = time_ms(lambda: tk.topk_cuda(q, items, excl, k=k), 50)
        plain = time_ms(lambda: tk.topk_plain(q, items, excl, k=k), 5)
        lib = time_ms(lambda: torch.topk(q @ dequantize(items).T, k), 50)
        dev = _device_times(
            torch, lambda: tk.topk_cuda(q, items, excl, k=k),
            lambda: torch.topk(q @ dequantize(items).T, k), f"B={b}")
        dp = items.packed.shape[1]
        n_bytes = (n_items * dp + 8 * n_items + b * d * 4 + excl.numel() * 4
                   + b * k * 8)
        entries.append(_entry(
            "topk_score", "topk_score", "src/repro/kernels/topk_score.py:115",
            err, ms, plain, lib, n_bytes, 2 * b * n_items * d + 2 * n_items * d,
            f"B={b} I={n_items} d={d} k={k} int8", kernels_per_call=n_k,
            library_call="torch.topk(q @ dequantize(items).T)", **dev))
    _tile_sweep(torch, tk, quantize, gen, n_items, d, k)
    # k past 128: the rounds route (pass 1 sorts each item tile)
    for ties in (True, False):
        q, items, excl = _topk_inputs(torch, quantize, gen, ENGINE_BATCH,
                                      n_items, d, ties=ties)
        kv, ki = tk.topk_cuda(q, items, excl, k=LARGE_K)
        pv, pi = tk.topk_plain(q, items, excl, k=LARGE_K)
        scale = float(pv.abs().max())
        err = float((kv - pv).abs().max())
        near = bool(((kv - pv).abs()[ki != pi] <= TOL * scale).all())
        same = torch.equal(ki, pi) and torch.equal(kv, pv)
        log(f"  k={LARGE_K} B={ENGINE_BATCH} "
            f"{'integer-valued ties' if ties else 'random'}: "
            f"{'bit-identical' if same else f'values rel {err / scale:.3e}'}")
        check(same if ties else (err <= TOL * scale and near),
              f"topk k={LARGE_K} ties={ties} differs")
    _count_kernels(torch, tk, lambda: tk.topk_cuda(q, items, excl,
                                                   k=LARGE_K),
                   ENGINE_BATCH, items, LARGE_K, False)
    # the JSON line's shape: B=128, the streaming eval's calls
    return _with_other_shape(entries[-1], *entries[:-1])


def _unpack_affine(torch, q8, qmeta, items):
    """The coarse score matrix from library calls: unpack, one fp32
    product, the affine step."""
    from repro_torch.core.quant import unpack_bits

    codes = unpack_bits(items.packed, items.bits, items.dim).to(torch.float32)
    return ((q8 @ codes.T) * (qmeta[:, 0:1] * items.scale.T)
            + qmeta[:, 1:2] * items.zero.T)


def check_coarse(torch, tk, gen):
    """The coarse scan at the store's item-table shape: INT8 (dp 256) and
    INT4 (dp 128), B 1, the engine's batch and the eval's user chunk at m
    80, and the m = n_items anchor; bit-identical to the plain version.
    Timed on the full table at B 1, 8 and 128, and on a tier-2 shard's
    table at B 8."""
    from repro_torch.core.quant import QTensor, quantize
    from repro_torch.serving.scorer import quantize_query

    n_items, d = DATASET["n_items"], 256
    log(f"[coarse_topm] kernel vs plain (values and indices bit-identical), "
        f"I={n_items} d={d}, 12 exclusions")
    timed = {}
    for bits in (8, 4):
        for b, m in [(b, COARSE_M) for b in COARSE_BATCH] + [
                (ENGINE_BATCH, n_items)]:
            for ties in (True, False):
                q, items, excl = _topk_inputs(torch, quantize, gen, b,
                                              n_items, d, ties=ties)
                if bits == 4:
                    items = quantize(torch.randn((n_items, d), generator=gen,
                                                 device=DEV) * 0.3, 0,
                                     bits=4)
                q8, qmeta = quantize_query(q)
                kv, ki = tk.coarse_topm_cuda(q8, qmeta, items, excl, m=m)
                pv, pi = tk.coarse_topm_plain(q8, qmeta, items, excl, m=m)
                same = torch.equal(ki, pi) and torch.equal(kv, pv)
                log(f"  bits={bits} B={b} m={m} "
                    f"{'ties' if ties and bits == 8 else 'random'}: "
                    f"{'bit-identical' if same else 'MISMATCH'}")
                check(same, f"coarse_topm bits={bits} B={b} m={m} differs")
            if bits == 8 and m == COARSE_M:
                timed[b] = (q8, qmeta, items, excl)
    q8, qmeta, items, excl = timed[ENGINE_BATCH]
    shard = QTensor(items.packed[:SHARD_ITEMS], items.scale[:SHARD_ITEMS],
                    items.zero[:SHARD_ITEMS], items.bits, items.dim)
    ex = torch.where(excl < SHARD_ITEMS, excl, -1)
    same = all(torch.equal(a, b) for a, b in zip(
        tk.coarse_topm_cuda(q8, qmeta, shard, ex, m=COARSE_M),
        tk.coarse_topm_plain(q8, qmeta, shard, ex, m=COARSE_M)))
    log(f"  shard table I={SHARD_ITEMS} B={ENGINE_BATCH} m={COARSE_M}: "
        f"{'bit-identical' if same else 'MISMATCH'}")
    check(same, "coarse_topm on a shard-sized table differs")
    _count_kernels(torch, tk, lambda: tk.coarse_topm_cuda(q8, qmeta, items,
                                                          excl, m=n_items),
                   ENGINE_BATCH, items, n_items, True)
    entries = []
    shapes = [(b, timed[b][2], timed[b][3], timed[b][0], timed[b][1])
              for b in COARSE_BATCH]
    shapes.insert(2, (ENGINE_BATCH, shard, ex, q8, qmeta))
    for b, items, excl, q8, qmeta in shapes:
        m, n = COARSE_M, items.rows
        n_k = _count_kernels(
            torch, tk, lambda: tk.coarse_topm_cuda(q8, qmeta, items, excl,
                                                   m=m), b, items, m, True)
        ms = time_ms(lambda: tk.coarse_topm_cuda(q8, qmeta, items, excl,
                                                 m=m), 50)
        plain = time_ms(lambda: tk.coarse_topm_plain(q8, qmeta, items, excl,
                                                     m=m), 5)
        err = float((tk.coarse_topm_cuda(q8, qmeta, items, excl, m=m)[0]
                     - tk.coarse_topm_plain(q8, qmeta, items, excl, m=m)[0])
                    .abs().max())
        lib = time_ms(lambda: torch.topk(_unpack_affine(torch, q8, qmeta,
                                                        items), m), 50)
        dev = _device_times(
            torch, lambda: tk.coarse_topm_cuda(q8, qmeta, items, excl, m=m),
            lambda: torch.topk(_unpack_affine(torch, q8, qmeta, items), m),
            f"B={b} I={n}")
        dp = items.packed.shape[1]
        n_bytes = (n * dp + 8 * n + b * d * 4 + b * 8 + excl.numel() * 4
                   + b * m * 8)
        entries.append(_entry(
            "coarse_topm", "coarse_topm",
            "src/repro/kernels/topk_score.py:129", err, ms, plain, lib,
            n_bytes, 2 * b * n * d, f"B={b} I={n} d={d} m={m} int8",
            peak=INT8_OPS, kernels_per_call=n_k,
            library_call="torch.topk(affine(q8 @ unpack(packed).T), m), "
                         "no exclusions", **dev))
    # the JSON line's shape: B=128, the [accuracy] phase's two-stage calls
    return _with_other_shape(entries[-1], *entries[:-1])


def _with_other_shape(entry, *others):
    """``entry`` (the JSON line's shape) carrying the timings of ``others``
    (one: a dict; several: a list)."""
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "kernels_per_call", "device_ms",
            "library_device_ms")
    rows = [{k: o[k] for k in keys if k in o} for o in others]
    entry["other_shape"] = rows[0] if len(rows) == 1 else rows
    return entry


def check_dequant_unpack(torch, qp, gen):
    """Unpack + dequantize at the item table's shape (INT8 and INT4) and at
    the re-rank's (B*m candidate rows), bits 2 and 1, and a padded pack;
    bit-identical to the plain version."""
    from repro_torch.core.quant import quantize

    n_items, d = DATASET["n_items"], 256
    rerank_rows = ENGINE_BATCH * COARSE_M
    log(f"[dequant_unpack] kernel vs plain (bit-identical)")
    out = {}
    for rows, dim, bits in ((n_items, d, 8), (n_items, d, 4),
                            (rerank_rows, d, 8), (4096, d, 2), (4096, d, 1),
                            (4096, 37, 4), (4096, 37, 2)):
        q = quantize(torch.randn((rows, dim), generator=gen, device=DEV)
                     * 0.3, 0xD0 + bits, bits=bits, stochastic=True)
        got = qp.dequant_unpack_cuda(q.packed, q.scale, q.zero, bits=bits,
                                     dim=dim)
        ref = qp.dequant_unpack_plain(q.packed, q.scale, q.zero, bits=bits,
                                      dim=dim)
        same = torch.equal(got, ref)
        log(f"  {rows}x{dim} bits={bits} (dp {q.packed.shape[1]}): "
            f"{'bit-identical' if same else 'MISMATCH'}")
        check(same, f"dequant_unpack {rows}x{dim} bits={bits} differs")
        if dim == d and bits == 8:
            out[rows] = q
    entries = []
    for rows in (rerank_rows, n_items):
        q = out[rows]
        args = (q.packed, q.scale, q.zero)
        err = float((qp.dequant_unpack_cuda(*args, bits=8, dim=d)
                     - qp.dequant_unpack_plain(*args, bits=8, dim=d))
                    .abs().max())
        ms = time_ms(lambda: qp.dequant_unpack_cuda(*args, bits=8, dim=d),
                     100)
        plain = time_ms(lambda: qp.dequant_unpack_plain(*args, bits=8,
                                                        dim=d), 20)
        n_bytes = rows * q.packed.shape[1] + 8 * rows + rows * d * 4
        entries.append(_entry(
            "dequant_unpack", "dequant_unpack",
            "src/repro/kernels/quant_pack.py:171", err, ms, plain, None,
            n_bytes, 2 * rows * d, f"R={rows} d={d} int8"))
    return _with_other_shape(entries[1], entries[0])   # the item table


def _sddmm_library(torch, g):
    """cuSPARSE SDDMM over the graph's coalesced CSR pattern (duplicate
    edges merged), and a map from each edge to its value's position."""
    m = g.layout.meta
    src, dst = g.src.long(), g.dst.long()
    with warnings.catch_warnings():      # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(
            torch.stack([dst, src]),
            torch.ones(m.n_edges, device=DEV), (m.n_dst, m.n_src)
        ).coalesce().to_sparse_csr()
    rows = torch.repeat_interleave(
        torch.arange(m.n_dst, device=DEV), a.crow_indices().diff())
    keys = rows * m.n_src + a.col_indices()
    pos = torch.searchsorted(keys, dst * m.n_src + src)

    def run(x, grad):
        return torch.sparse.sampled_addmm(a, grad, x.T, beta=0.0)

    return run, pos


def _entry(name, source, replaces, err, ms, plain, lib, n_bytes, n_ops,
           shape, *, peak=FP32_FLOPS, **extra):
    bnd, by = bound_ms(n_bytes, n_ops, peak)
    lib_s = "none (no single call)" if lib is None else f"{lib:.4f} ms"
    log(f"  time {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
        f"{lib_s}, bound {bnd:.4f} ms ({by}; {n_bytes / 1e6:.3f} MB, "
        f"{n_ops / 1e9:.3f} G ops at {peak / 1e12:g} T/s)")
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/csrc/{source}.cu",
                replaces=replaces, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
                shape=shape, **extra)


def check_sddmm(torch, sp, g, gen):
    """The fp32-residual SDDMM at full width: the FP32 layers' ∇ew (d 64)
    and the edge softmax's denominators (d 1, every schedule)."""
    log("[sddmm] kernel vs plain on the full-width KGAT graph")
    m = g.layout.meta
    for d in (1, 64):
        x = torch.randn((m.n_src, d), generator=gen, device=DEV) * 0.1
        grad = torch.randn((m.n_dst, d), generator=gen, device=DEV) * 1e-3
        out1 = sp.sddmm_cuda(x, grad, g.layout)
        same = torch.equal(out1, sp.sddmm_cuda(x, grad, g.layout))
        ref = sp.sddmm_plain(x, grad, g.layout)
        rel, err = _rel(out1, ref), float((out1 - ref).abs().max())
        log(f"  d={d}: rel {rel:.3e} (max abs {err:.3e}), two runs "
            f"{'bit-identical' if same else 'DIFFER'}")
        check(rel <= TOL and same,
              f"sddmm d={d}: rel {rel}, deterministic {same}")
    # timing: the FP32 layers' call at d 64 (the last case)
    lib_fn, pos = _sddmm_library(torch, g)
    lib_rel = _rel(lib_fn(x, grad).values()[pos], ref)
    check(lib_rel <= TOL, f"library sampled_addmm disagrees ({lib_rel})")
    ms = time_ms(lambda: sp.sddmm_cuda(x, grad, g.layout), 20)
    plain = time_ms(lambda: sp.sddmm_plain(x, grad, g.layout), 5)
    lib = time_ms(lambda: lib_fn(x, grad), 20)
    # the function's bytes: x and g read once, two indices in and one value
    # out per edge
    n_bytes = (m.n_src + m.n_dst) * d * 4 + m.n_edges * 12
    return _entry("sddmm", "sddmm", "src/repro/kernels/spmm.py:334", err, ms,
                        plain, lib, n_bytes, 2 * m.n_edges * d,
                        f"E={m.n_edges} n={m.n_dst} d={d} fp32")


def check_dequant_sddmm(torch, sp, g, gen):
    """The packed-residual SDDMM (the INT-b ∇ew) at full width."""
    from repro_torch.core.quant import dequantize, quantize

    log("[dequant_sddmm] kernel vs plain on the full-width KGAT graph")
    m = g.layout.meta
    lib_fn, pos = _sddmm_library(torch, g)
    timed = {}
    for bits, d in ((8, 64), (4, 64), (1, 64), (2, 37), (2, 64)):
        x = torch.randn((m.n_src, d), generator=gen, device=DEV) * 0.1
        grad = torch.randn((m.n_dst, d), generator=gen, device=DEV) * 1e-3
        q = quantize(x, 0xACE + bits, bits=bits, stochastic=True)
        out1 = sp.dequant_sddmm_cuda(q, grad, g.layout)
        same = torch.equal(out1, sp.dequant_sddmm_cuda(q, grad, g.layout))
        ref = sp.dequant_sddmm_plain(q, grad, g.layout)
        rel, err = _rel(out1, ref), float((out1 - ref).abs().max())
        log(f"  bits={bits} d={d} (dp {q.packed.shape[1]}): rel {rel:.3e} "
            f"(max abs {err:.3e}), two runs "
            f"{'bit-identical' if same else 'DIFFER'}")
        check(rel <= TOL and same,
              f"dequant_sddmm bits={bits} d={d}: rel {rel}, "
              f"deterministic {same}")
        if d == 64:
            timed[bits] = q
    # timing: the main path's INT2 call at d 64 (the last case), and INT8
    entries = []
    for q in (q, timed[8]):
        ref = sp.dequant_sddmm_plain(q, grad, g.layout)
        lib_rel = _rel(lib_fn(dequantize(q), grad).values()[pos], ref)
        check(lib_rel <= TOL, f"library dequantize+sampled_addmm disagrees "
              f"({lib_rel})")
        err = float((sp.dequant_sddmm_cuda(q, grad, g.layout) - ref)
                    .abs().max())
        ms = time_ms(lambda: sp.dequant_sddmm_cuda(q, grad, g.layout), 20)
        plain = time_ms(lambda: sp.dequant_sddmm_plain(q, grad, g.layout),
                        5)
        lib = time_ms(lambda: lib_fn(dequantize(q), grad), 20)
        dp = q.packed.shape[1]
        # packed table, scale/zero, g once; two indices in, one value out
        # per edge. Operations: dequantize each residual element once, then
        # the dot
        n_bytes = m.n_src * (dp + 8) + m.n_dst * d * 4 + m.n_edges * 12
        entries.append(_entry(
            "dequant_sddmm", "sddmm", "src/repro/kernels/spmm.py:398", err,
            ms, plain, lib, n_bytes, 2 * m.n_edges * d + 2 * m.n_src * d,
            f"E={m.n_edges} n={m.n_dst} d={d} INT{q.bits}",
            also_replaces="src/repro/kernels/spmm.py:466",
            library_call="dequantize + torch.sparse.sampled_addmm (CSR)"))
    return _with_other_shape(*entries)


def check_dequant_matmul(torch, dq, gen):
    """dW = dequant(q)ᵀ @ g at the training path's shape: every node's row,
    64 features in and out."""
    from repro_torch.core.quant import dequantize, quantize

    rows, n = DATASET["n_users"] + DATASET["n_items"] + DATASET["n_attrs"], 64
    log(f"[dequant_matmul] kernel vs plain, R={rows}, N={n}")
    for bits, d in ((8, 64), (4, 64), (1, 64), (2, 37), (2, 64)):
        x = torch.randn((rows, d), generator=gen, device=DEV) * 0.1
        grad = torch.randn((rows, n), generator=gen, device=DEV) * 1e-3
        q = quantize(x, 0xBEE + bits, bits=bits, stochastic=True)
        out1 = dq.dequant_matmul_cuda(q, grad)
        same = torch.equal(out1, dq.dequant_matmul_cuda(q, grad))
        ref = dq.dequant_matmul_plain(q, grad)
        rel, err = _rel(out1, ref), float((out1 - ref).abs().max())
        log(f"  bits={bits} d={d}: rel {rel:.3e} (max abs {err:.3e}), two "
            f"runs {'bit-identical' if same else 'DIFFER'}")
        check(rel <= TOL and same,
              f"dequant_matmul bits={bits} d={d}: rel {rel}, "
              f"deterministic {same}")
    ms = time_ms(lambda: dq.dequant_matmul_cuda(q, grad), 50)
    plain = time_ms(lambda: dq.dequant_matmul_plain(q, grad), 20)
    lib = time_ms(lambda: dequantize(q).T @ grad, 50)
    dp = q.packed.shape[1]
    n_bytes = rows * (dp + 8) + rows * n * 4 + d * n * 4
    return _entry("dequant_matmul", "dequant_matmul",
                  "src/repro/kernels/dequant_matmul.py:35", err, ms, plain,
                  lib, n_bytes, 2 * rows * d * n + 2 * rows * d,
                  f"R={rows} {d}x{n} INT2")


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
    log(f"[main] streaming eval (all users, top-K at B {EVAL_BATCH}): "
        f"{res['phases']['eval']['seconds']:.3f} s")
    log(f"[main] torch.cuda.max_memory_allocated {peak} B "
        f"({peak / 2**30:.2f} GiB)")
    log(f"[main] engine {res['stats']}")
    for name in SERVING:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never launched on the serving path")

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


# -- serving tier 2 -------------------------------------------------------------


def zipf_stream(n_users: int, n: int, *, a: float, seed: int):
    """n user ids from a zipf(a) popularity law over a fixed permutation of
    the users (the request stream of the reference's serving bench)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    order = rng.permutation(n_users)
    pmf = 1.0 / np.arange(1, n_users + 1) ** a
    pmf /= pmf.sum()
    return order[rng.choice(n_users, size=n, p=pmf)].astype(np.int32)


@contextlib.contextmanager
def audit_cache_replays(engine_cls):
    """Record every response the engine replays from its cache: (user,
    entry stamp, live version, values, indices)."""
    seen = []
    orig = engine_cls._replay

    def audited(self, msg, ent):
        seen.append((msg[1], ent[0], self.version, ent[1], ent[2]))
        orig(self, msg, ent)

    engine_cls._replay = audited
    try:
        yield seen
    finally:
        engine_cls._replay = orig


def _close_topk(torch, gv, gi, rv, ri):
    """(values rel, index swaps, ok): values within TOL of the reference's
    scale, indices equal except between scores within it."""
    gv, gi, rv, ri = (torch.as_tensor(a) for a in (gv, gi, rv, ri))
    scale = float(rv[torch.isfinite(rv)].abs().max())
    diff = (gv - rv).abs()
    err = float(diff.max()) / scale
    swapped = gi != ri
    ok = err <= TOL and bool((diff[swapped] <= TOL * scale).all())
    return err, int(swapped.sum()), ok


def run_tier2_path(torch, cfg, ds, g, params):
    """The tier-2 serving path at full width through ``serve_kgnn``:
    two-stage C 4, 2 item shards, a 4,096-entry hot-user cache, 400
    zipfian requests, 2 FP32 BPR steps, a re-roll and a delta refresh, a
    second burst. Counts are reset just before and read just after."""
    import numpy as np

    from repro_torch.kernels import backend
    from repro_torch.launch.serve import serve_kgnn
    from repro_torch.obs import get_registry
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.store import padded_pos_lists

    users = zipf_stream(ds.n_users, REQUESTS, a=ZIPF_A, seed=0)
    with audit_cache_replays(ServingEngine) as replays:
        torch.cuda.synchronize()
        backend.reset_counts()
        res = serve_kgnn(cfg, ds, params, bits=8, k=20, users=users,
                         device=DEV, graph=g, dense_users=DENSE_USERS,
                         log=log, **TIER2)
        counts = dict(backend.LAUNCH_COUNTS)
    log(f"[tier2] LAUNCH_COUNTS {json.dumps(counts, sort_keys=True)}")
    for name, ph in res["phases"].items():
        log(f"[tier2] phase {name}: {ph['seconds']:.3f} s, launches "
            f"{json.dumps(ph['launches'], sort_keys=True)}")
    for name in TIER2_KERNELS:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never launched on the tier-2 path")

    snap = get_registry().snapshot()
    lab = res["label"]
    stages = {st: snap["histograms"][f"serve/stage_ms{{engine={lab},"
                                     f"stage={st}}}"]
              for st in ("coarse", "rerank")}
    frac = snap["gauges"][f"serve/candidate_frac{{engine={lab}}}"]
    st1, st2 = res["stats"], res["stats_post"]
    # the single-stage, unsharded, uncached engine on the same requests
    exclude = padded_pos_lists(ds.train_pos, ds.n_users)
    with ServingEngine(res["store"], k=20, exclude=exclude,
                       buckets=(1, 2, 4, 8)) as base:
        base.warmup()
        futs = [base.submit(int(u)) for u in users]
        base_res = [f.result(timeout=300) for f in futs]
        st0 = base.stats()
    log(f"[tier2] {REQUESTS} zipfian requests (a {ZIPF_A}, seed 0, "
        f"{len(set(users.tolist()))} distinct users): tier-2 engine "
        f"{st1.qps:.1f} QPS, p50 {st1.p50_ms:.3f} ms, p99 {st1.p99_ms:.3f} "
        f"ms, {st1.n_batches} batches, cache hit rate "
        f"{st1.cache_hit_rate:.4f}; single-stage engine {st0.qps:.1f} QPS, "
        f"p50 {st0.p50_ms:.3f} ms, p99 {st0.p99_ms:.3f} ms, "
        f"{st0.n_batches} batches")
    for st, h in stages.items():
        log(f"[tier2] stage {st}: {h['count']} calls (per shard per "
            f"batch, both bursts; CUDA events on the shard's own stream), p50 {h['p50']:.3f} ms, p99 "
            f"{h['p99']:.3f} ms, mean {h['sum'] / max(h['count'], 1):.3f} "
            f"ms")
    log(f"[tier2] candidate_frac {frac:.6f}; post-refresh burst: "
        f"{st2.n_requests - st1.n_requests} requests, cumulative {st2}")

    # the tier-2 answers against the single-stage engine's (two-stage
    # recall: the same top-20 ids, as a share)
    same_ids = np.mean([len(set(a[1].tolist()) & set(b[1].tolist())) / 20
                        for a, b in zip(res["results"], base_res)])
    log(f"[tier2] first burst: share of the single-stage top-20 ids "
        f"served {same_ids:.4f}")

    # the refresh: the live store is the new rollout, bit for bit
    live, new = res["live_store"], res["new_store"]
    same = all(torch.equal(a, b) for s_t, n_t in
               ((live.users, new.users), (live.items, new.items))
               for a, b in ((s_t.packed, n_t.packed), (s_t.scale, n_t.scale),
                            (s_t.zero, n_t.zero)))
    log(f"[tier2] refresh {json.dumps(res['delta'], sort_keys=True)}; live "
        f"store vs new rollout: {'bit-identical' if same else 'MISMATCH'}")
    check(same, "the refreshed store is not the new rollout")
    check(res["delta"]["version"] == 1 and st2.store_version == 1,
          "store version after the refresh")

    # every cache hit: stamp == live version, and a fresh score agrees
    check(len(replays) > 0, "no cache hit on zipfian traffic")
    by_version = {0: res["store"], 1: live}
    n_exact = 0
    for v, store in by_version.items():
        hits = [r for r in replays if r[2] == v]
        check(all(r[1] == v for r in hits),
              f"a cache hit served under version {v} carries another stamp")
        if not hits:
            continue
        with ServingEngine(store, k=20, exclude=exclude,
                           buckets=(1, 2, 4, 8), two_stage_c=TIER2[
                               "two_stage"],
                           item_shards=TIER2["item_shards"]) as fresh:
            fv, fi = fresh.score_batch(np.array([r[0] for r in hits]))
        hv = np.stack([r[3] for r in hits])
        hi = np.stack([r[4] for r in hits])
        err, swaps, ok = _close_topk(torch, hv, hi, fv, fi)
        n_exact += int(sum(np.array_equal(a, b) and np.array_equal(c, d_)
                           for a, b, c, d_ in zip(hv, fv, hi, fi)))
        log(f"[tier2] version {v}: {len(hits)} cache hits, every stamp "
            f"v{v}; against a fresh score: values rel {err:.3e}, "
            f"{swaps} index swaps (near-ties)")
        check(ok, f"cache hits of version {v} differ from a fresh score")
    check(any(r[2] == 1 for r in replays),
          "no post-refresh cache hit carried the new version")
    log(f"[tier2] {len(replays)} cache hits checked, {n_exact} bit-identical "
        f"to the fresh score (the re-rank's batched product may sum in "
        f"another order at another batch size)")
    return counts, res


def check_tier2_served(torch, ds, res):
    """Hold what the tier-2 path served against plain versions: the coarse
    kernel on the served store's shard tables at the engine's batch sizes
    (bit-identical), and the first burst's responses against two-stage
    retrieval run on the plain versions per shard, merged on the host."""
    import numpy as np

    from repro_torch.core.quant import dequantize as dequantize_plain
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_score as tk
    from repro_torch.serving.engine import _shard_items
    from repro_torch.serving.scorer import (merge_topk, quantize_query,
                                            two_stage_topk)
    from repro_torch.serving.store import padded_pos_lists

    store, k, c = res["store"], res["k"], TIER2["two_stage"]
    shards = _shard_items(store.items, TIER2["item_shards"])
    offs = np.cumsum([0] + [s.rows for s in shards])[:-1]
    excl_all = torch.from_numpy(padded_pos_lists(ds.train_pos,
                                                 ds.n_users)).to(DEV)
    users = res["users"]
    for b in (1, 2, 4, 8):            # the engine's buckets
        ids = torch.from_numpy(users[:b]).to(DEV)
        q8, qmeta = quantize_query(store.user_vectors(ids))
        for off, sh in zip(offs, shards):
            m = max(k, min(c * k, sh.rows))
            ex = excl_all[ids] - int(off)
            kv, ki = tk.coarse_topm_cuda(q8, qmeta, sh, ex, m=m)
            pv, pi = tk.coarse_topm_plain(q8, qmeta, sh, ex, m=m)
            same = torch.equal(ki, pi) and torch.equal(kv, pv)
            check(same, f"coarse_topm on shard {off}+{sh.rows} at B={b} "
                  f"m={m} differs from plain")
    log(f"[tier2] coarse_topm on the served shard tables "
        f"({', '.join(str(s.rows) for s in shards)} items) at B 1/2/4/8, "
        f"m {max(k, c * k)}, the burst's users and exclusions: "
        f"bit-identical to plain")

    n = SERVED_USERS
    ids = torch.from_numpy(users[:n]).to(DEV)
    q, excl = store.user_vectors(ids), excl_all[ids]
    with plain_versions(ops, coarse_topm=tk.coarse_topm_plain,
                        dequantize=dequantize_plain):
        parts = [two_stage_topk(q, sh, min(k, sh.rows), c=c,
                                exclude=excl - int(off))
                 for off, sh in zip(offs, shards)]
    pv, pi = merge_topk([p[0].cpu().numpy() for p in parts],
                        [p[1].cpu().numpy() + int(off)
                         for p, off in zip(parts, offs)], k)
    ev = np.stack([r[0] for r in res["results"][:n]])
    ei = np.stack([r[1] for r in res["results"][:n]])
    err, swaps, ok = _close_topk(torch, ev, ei, pv, pi)
    hit = bool((torch.from_numpy(ei).to(DEV)[:, :, None]
                == excl[:, None, :]).any())
    log(f"[tier2] first-burst responses for {n} users vs two-stage on the "
        f"plain versions (per shard, host merge): values rel {err:.3e}, "
        f"{swaps} index swaps (near-ties), excluded ids returned: {hit}")
    check(ok and not hit, "tier-2 responses differ from the plain two-stage "
          "retrieval")


def profile_serving_batch(torch, ds, store):
    """torch.profiler over engine batches of 8 users (``score_batch``) on
    the single-stage and the tier-2 engine: wall time per batch, device
    busy time, idle share, device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.store import padded_pos_lists

    exclude = padded_pos_lists(ds.train_pos, ds.n_users)
    ids = zipf_stream(ds.n_users, 8 * PROFILED_BATCHES, a=ZIPF_A, seed=1)
    for label, kw in (("single-stage", {}),
                      ("tier-2", dict(two_stage_c=TIER2["two_stage"],
                                      item_shards=TIER2["item_shards"]))):
        with ServingEngine(store, k=20, exclude=exclude,
                           buckets=(1, 2, 4, 8), **kw) as eng:
            eng.warmup()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for b in range(PROFILED_BATCHES):
                    eng.score_batch(ids[8 * b:8 * b + 8])
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / PROFILED_BATCHES
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total
                   for e in kernels) / 1e3 / PROFILED_BATCHES
        log(f"[profile] {label} engine batch of 8 (mean of "
            f"{PROFILED_BATCHES}): wall {wall:.3f} ms, device busy "
            f"{busy:.3f} ms, idle share "
            + (f"{1 - busy / wall:.3f}" if busy > 0 else
               "not measured (no device events)"))
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
                f"x{e.count:<4d} {e.key[:100]}")


def check_two_stage_accuracy(torch, ds, store):
    """Two-stage recall@20 against single stage on all users (printed, not
    checked: a property of the weights), and the m = n_items anchor on
    256 users against the single-stage top-K kernel."""
    from repro_torch.serving.eval import streaming_eval_dataset
    from repro_torch.serving.scorer import topk_scores, two_stage_topk
    from repro_torch.serving.store import padded_pos_lists

    t0 = time.perf_counter()
    r1, n1 = streaming_eval_dataset(store, ds, k=20)
    t1 = time.perf_counter()
    r2, n2 = streaming_eval_dataset(store, ds, k=20,
                                    two_stage_c=TIER2["two_stage"])
    t2 = time.perf_counter()
    log(f"[accuracy] all {ds.n_users} users: recall@20 single-stage {r1:.6f} "
        f"({t1 - t0:.3f} s), two-stage C {TIER2['two_stage']} {r2:.6f} "
        f"({t2 - t1:.3f} s), ratio {r2 / max(r1, 1e-12):.4f}; ndcg@20 "
        f"{n1:.6f} / {n2:.6f}")
    excl_all = torch.from_numpy(padded_pos_lists(ds.train_pos, ds.n_users))
    c_all = -(-ds.n_items // 20)
    worst, swaps = 0.0, 0
    n_users = min(ANCHOR_USERS, ds.n_users)
    for u0 in range(0, n_users, 64):
        ids = torch.arange(u0, min(u0 + 64, n_users), device=DEV)
        q = store.user_vectors(ids)
        excl = excl_all.to(DEV)[ids]
        av, ai = two_stage_topk(q, store.items, 20, c=c_all, exclude=excl)
        sv, si = topk_scores(q, store.items, 20, exclude=excl)
        err, n_sw, ok = _close_topk(torch, av, ai, sv, si)
        worst, swaps = max(worst, err), swaps + n_sw
        check(ok, f"two-stage anchor (m = n_items) differs from single "
              f"stage for users from {u0}")
    log(f"[accuracy] anchor C {c_all} (m = n_items = {ds.n_items}) on "
        f"{n_users} users vs the single-stage kernel: values rel "
        f"{worst:.3e}, {swaps} index swaps (near-ties)")


# -- the training path -------------------------------------------------------


def _path_kernels(label):
    return ("spmm", "sddmm") + (() if label == "fp32" else
                                ("quant_pack", "dequant_sddmm",
                                 "dequant_matmul"))


def run_training(torch, cfg, ds, g):
    """Train at full width under each schedule from the same seed-0
    parameters; the launch counts of each run are its own."""
    from repro_torch.core.policy import parse_schedule
    from repro_torch.kernels import backend
    from repro_torch.launch.train import train_kgnn
    from repro_torch.models import kgnn

    runs = {}
    for label in SCHEDULES:
        params = kgnn.init_params(cfg, seed=0, device=DEV)
        torch.cuda.synchronize()
        backend.reset_counts()
        res = train_kgnn(cfg, ds, params, parse_schedule(label), TRAIN_STEPS,
                         batch=TRAIN_BATCH, device=DEV, graph=g,
                         log=lambda _: None)
        counts = dict(backend.LAUNCH_COUNTS)
        steps = res["steps"]
        del res, params
        losses = [r["loss"] for r in steps]
        act = steps[0]["act"]
        per_step = steps[-1]["launches"]
        runs[label] = dict(
            counts=counts, losses=losses, per_step=per_step,
            step_ms=statistics.median(r["seconds"] for r in steps) * 1e3,
            first_ms=steps[0]["seconds"] * 1e3,
            peak=max(r["max_memory_allocated"] for r in steps),
            act_bytes=act["total_bytes"], act_fp32=act["total_fp32_bytes"])
        r = runs[label]
        log(f"[train] {label}: losses {[f'{v:.6f}' for v in losses]}")
        log(f"[train] {label}: step {r['step_ms']:.2f} ms median of "
            f"{len(steps)} (first {r['first_ms']:.2f} ms), "
            f"max_memory_allocated {r['peak']} B ({r['peak'] / 2**30:.2f} "
            f"GiB), ACT residual bytes {r['act_bytes']} "
            f"({r['act_bytes'] / 1e6:.1f} MB; FP32 {r['act_fp32'] / 1e6:.1f} "
            f"MB, {r['act_fp32'] / r['act_bytes']:.2f}x)")
        log(f"[train] {label}: launches per step "
            f"{json.dumps(per_step, sort_keys=True)}; run total "
            f"{json.dumps(counts, sort_keys=True)}")
        check(all(math.isfinite(v) for v in losses),
              f"{label}: non-finite loss")
        for name in _path_kernels(label):
            check(counts.get(name, 0) > 0,
                  f"kernel {name} never launched on the {label} training "
                  f"path")
        check(all(s_["launches"] == per_step for s_ in steps),
              f"{label}: launches differ between steps")
    n_sites = 5 * cfg.n_layers
    want = n_sites * cfg.n_nodes * cfg.dim * 4
    check(all(r["act_fp32"] == want for r in runs.values())
          and runs["fp32"]["act_bytes"] == want,
          f"FP32 ACT bytes are not {n_sites} sites x {cfg.n_nodes} x "
          f"{cfg.dim} fp32")
    check(runs["int2"]["act_bytes"] == n_sites * cfg.n_nodes
          * (cfg.dim * 2 // 8 + 8), "INT2 ACT bytes")
    log(f"[train] traced ACT bytes INT2 / FP32: "
        f"{runs['int2']['act_bytes']} / {runs['fp32']['act_bytes']} = 1 / "
        f"{runs['fp32']['act_bytes'] / runs['int2']['act_bytes']:.2f}")
    return runs


def profile_step(torch, cfg, ds, g, label="int2"):
    """torch.profiler over one steady training step: device time by
    kernel, busy time and idle share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.policy import parse_schedule
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.models.registry import build_step
    from repro_torch.training.optimizer import adam
    from repro_torch.training.step import make_train_step

    step = build_step("kgat", ds=ds, cfg=cfg, batch_size=TRAIN_BATCH,
                      device=DEV, graph=g)
    opt = adam(step.lr)
    params = step.init(0)
    train = make_train_step(step, opt, schedule=parse_schedule(label),
                            root_seed=ROOT_SEED)
    batches = step.batches()
    state = (params, opt.init(params))
    state, m = train(state, next(batches), 0)         # warm
    batch = next(batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = train(state, batch, 1)
        float(m["loss"])
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {label} step: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share "
        + (f"{1 - busy / (wall * 1e3):.3f}" if busy > 0 else
           "not measured (no device events)"))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:110]}")


def _grads(torch, step, params, batch, label):
    from repro_torch.core.context import act_context
    from repro_torch.core.policy import parse_schedule
    from repro_torch.launch.train import ROOT_SEED
    from repro_torch.models.layers import param_leaves

    ctx = act_context(parse_schedule(label), ROOT_SEED, step=0)
    loss = step.loss(params, batch, ctx=ctx)
    grads = torch.autograd.grad(loss, param_leaves(params))
    return float(loss.detach()), grads


def _fp64_versions(torch, g):
    """SPMM and SDDMM over the graph's COO edges in the inputs' dtype (the
    float64 reference step of ``check_train_grads``)."""
    src, dst = g.src.long(), g.dst.long()

    def spmm(x, ew, layout, *, transpose=False):
        a, b = (dst, src) if transpose else (src, dst)
        m = layout.meta
        out = torch.zeros((m.n_src if transpose else m.n_dst,
                           x.shape[1]), dtype=x.dtype, device=x.device)
        msgs = x.index_select(0, a)
        if ew is not None:
            msgs = msgs * ew.to(x.dtype)[:, None]
        return out.index_add_(0, b, msgs)

    def grad_ew(res, grad, layout):
        return (res.index_select(0, src) * grad.index_select(0, dst)).sum(-1)

    return spmm, grad_ew


def _err64(got, ref):
    """(rms, max) of ``got - ref`` relative to ``ref``'s rms and max."""
    diff = got.double() - ref
    return (float(diff.square().mean().sqrt() / ref.square().mean().sqrt()),
            float(diff.abs().max() / ref.abs().max()))


def check_train_grads(torch, cfg, ds, g):
    """One full-width step with the kernels against the same step with
    every kernel's plain version (same seeds, parameters and batch); at
    FP32 both against the same step in float64. All steps run under
    ``torch.use_deterministic_algorithms``: the plain SPMM's ``index_add_``
    then sums each row in a fixed order, where its atomics' order moved the
    plain error from run to run (a LeakyReLU input within 2e-8 of 0 flips
    with the order, and moves w2[0]'s error 25x)."""
    from repro_torch.core.quant import QTensor
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import spmm as sp
    from repro_torch.models.layers import param_leaves
    from repro_torch.models.registry import build_step
    from repro_torch.training.step import trainable

    def grad_ew_plain(res, grad, layout):
        if isinstance(res, QTensor):
            return sp.dequant_sddmm_plain(res, grad, layout)
        return sp.sddmm_plain(res, grad, layout)

    step = build_step("kgat", ds=ds, cfg=cfg, batch_size=TRAIN_BATCH,
                      device=DEV, graph=g)
    batch = next(step.batches())
    params = step.init(0)
    names = [f"{k}[{i}]" if isinstance(params[k], list) else k
             for k in sorted(params)
             for i in range(len(params[k]) if isinstance(params[k], list)
                            else 1)]
    check(len(names) == len(param_leaves(params)), "parameter names")
    got = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for label in ("fp32", "int2"):
                got[label, "kernels"] = _grads(torch, step, params, batch,
                                               label)
                with plain_versions(ops, spmm=sp.spmm_plain,
                                    quant_pack=qp.quant_pack_plain,
                                    spmm_grad_ew=grad_ew_plain,
                                    dequant_matmul=dq.dequant_matmul_plain):
                    got[label, "plain"] = _grads(torch, step, params, batch,
                                                 label)
            spmm64, grad_ew64 = _fp64_versions(torch, g)
            p64 = trainable({k: [t.double() for t in v]
                             if isinstance(v, list) else v.double()
                             for k, v in params.items()})
            with plain_versions(ops, spmm=spmm64, spmm_grad_ew=grad_ew64):
                l64, g64 = _grads(torch, step, p64, batch, "fp32")
    finally:
        torch.use_deterministic_algorithms(False)
    for label in ("fp32", "int2"):
        (lk, gk), (lp, gp) = got[label, "kernels"], got[label, "plain"]
        check(abs(lk - lp) <= TOL * abs(lp),
              f"{label} loss with kernels {lk} vs plain {lp}")
        worst = 0.0
        for i, name in enumerate(names):
            diff = float((gk[i] - gp[i]).abs().max())
            if label == "fp32":
                err_k, max_k = _err64(gk[i], g64[i])
                err_p, max_p = _err64(gp[i], g64[i])
                share = err_k / max(err_p, TOL / GRAD_FP64_RATIO)
                ok = err_k <= max(GRAD_FP64_RATIO * err_p, TOL)
                note = (f", error vs float64 (rms; max): kernels {err_k:.3e}"
                        f"; {max_k:.3e}, plain {err_p:.3e}; {max_p:.3e}")
            else:
                noise = float((gk[i] - got["fp32", "kernels"][1][i])
                              .abs().max())
                share = diff / noise
                ok = share <= GRAD_NOISE_SHARE
                note = f", share of SR noise {share:.3e}"
            worst = max(worst, share)
            log(f"[grads] {label} {name}: max |kernels - plain| {diff:.3e}, "
                f"rel {diff / float(gp[i].abs().max()):.3e}{note}")
            check(ok, f"{label} gradient of {name} out of tolerance")
        log(f"[grads] {label}: loss kernels {lk:.8f} plain {lp:.8f}"
            + (f" float64 {l64:.8f}; worst rms error ratio kernels / "
               f"max(plain, {TOL / GRAD_FP64_RATIO:g}) "
               f"{worst:.3f} (limit {GRAD_FP64_RATIO})"
               if label == "fp32" else
               f"; worst SR-noise share {worst:.3e} (limit "
               f"{GRAD_NOISE_SHARE})"))


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
    from repro_torch.kernels import dequant_matmul as dq
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import spmm as sp
    from repro_torch.kernels import topk_score as tk
    from repro_torch.models import kgnn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
               check_topk(torch, tk, gen),
               check_sddmm(torch, sp, g, gen),
               check_dequant_sddmm(torch, sp, g, gen),
               check_dequant_matmul(torch, dq, gen),
               check_coarse(torch, tk, gen),
               check_dequant_unpack(torch, qp, gen)]
    check_reduced_rollout(torch)

    counts, res = run_main_path(torch, cfg, ds, g, params)
    check_served_path(torch, cfg, ds, g, params, res)
    del res
    counts_t2, res = run_tier2_path(torch, cfg, ds, g, params)
    check_tier2_served(torch, ds, res)
    check_two_stage_accuracy(torch, ds, res["store"])
    profile_serving_batch(torch, ds, res["store"])
    del res
    runs = run_training(torch, cfg, ds, g)
    profile_step(torch, cfg, ds, g)
    check_train_grads(torch, cfg, ds, g)
    # launches: the sum over the main-path runs (serving, then training
    # under each schedule), each counted from 0 just before it
    for e in entries:
        by_path = {"serve": counts.get(e["name"], 0),
                   "serve_tier2": counts_t2.get(e["name"], 0)}
        by_path.update({f"train_{label}": r["counts"].get(e["name"], 0)
                        for label, r in runs.items()})
        e["launches_by_path"] = by_path
        e["launches_per_train_step"] = {
            label: r["per_step"].get(e["name"], 0)
            for label, r in runs.items()}
        e["launches"] = sum(by_path.values())
        check(e["launches"] > 0, f"kernel {e['name']} never launched")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launches_by_path", "launches_per_train_step")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    optional = ("also_replaces", "other_shape", "library_call",
                "kernels_per_call", "device_ms", "library_device_ms")
    print(json.dumps({"kernels": [
        {k: e[k] for k in keys + tuple(o for o in optional if o in e)}
        for e in entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
