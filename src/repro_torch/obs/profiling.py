"""Reading ``torch.profiler`` on the card, for the card tests and the chip
smoke; no path of the port calls it.

``python -m repro_torch.obs.profiling [--reads N]`` (on the card) counts,
over interleaved reads of one coarse top-M call (24,915 x 256 INT8 items,
B 8, m 80), how often each way of reading the profiler loses one of the
call's kernels, and how far the first kernel's converted start lies from
the host's time of the call."""

from __future__ import annotations

import argparse
import time

__all__ = ["profiled_kernels"]

_MATCH = ("scan_kernel", "merge_")


def _read(fn, match, margin_s: float):
    """One profiler session around one call of ``fn``, with ``margin_s``
    of idle time inside the capture window on both sides: the matching
    CUDA kernel events, and the host's microseconds from the session's
    start to the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        time.sleep(margin_s)
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(s in e.name for s in match)]
    return events, (t1 - t0) * 1e6


def profiled_kernels(fn, match=_MATCH, margin_s: float = 25e-3) -> list:
    """The names of the CUDA kernels, among those whose name holds one of
    ``match`` (by default the top-K scan and merge kernels), that one call
    of ``fn`` starts, as ``torch.profiler`` records them. The call runs
    ``margin_s`` of idle time inside the capture window on both sides:
    the profiler drops a device event whose converted timestamps fall
    outside the window, and the conversion from the card's clock to the
    host's is off by up to a few milliseconds either way on the H100
    machines (``main`` measures it)."""
    return [e.name for e in _read(fn, match, margin_s)[0]]


READINGS = {"bare": 0.0, "margins 1 ms": 1e-3, "margins 10 ms": 10e-3,
            "margins 25 ms": 25e-3}


def probe(fn, n_kernels: int, reads: int) -> dict:
    """``reads`` reads of each way in ``READINGS``, interleaved: for each,
    the reads that saw other than ``n_kernels`` kernels, and the first
    kernel's start in the trace minus the host's time of the call from
    the session's start (us, sorted): its spread is the clock skew."""
    out = {k: dict(lost=[], offset_us=[], s=0.0) for k in READINGS}
    for i in range(reads):
        for name, margin in READINGS.items():
            t = time.perf_counter()
            events, call_us = _read(fn, _MATCH, margin)
            r = out[name]
            r["s"] += time.perf_counter() - t
            if len(events) != n_kernels:
                r["lost"].append((i, len(events)))
            if events:
                r["offset_us"].append(
                    min(e.time_range.start for e in events) - call_us)
    for r in out.values():
        r["offset_us"].sort()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--reads", type=int, default=1000)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.quant import quantize
    from repro_torch.kernels import topk_score as tk
    from repro_torch.serving.scorer import quantize_query

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    items = quantize(torch.randn((24915, 256), generator=gen,
                                 device="cuda") * 0.3, 0, bits=8)
    q8, qmeta = quantize_query(
        torch.randn((8, 256), generator=gen, device="cuda") * 0.3)
    excl = torch.full((8, 12), -1, dtype=torch.int32, device="cuda")

    def fn():
        return tk.coarse_topm_cuda(q8, qmeta, items, excl, m=80)

    fn()
    torch.cuda.synchronize()
    n = tk.plan_for(8, items, 80, device="cuda", coarse=True).n_kernels
    for name, r in probe(fn, n, args.reads).items():
        o = r["offset_us"] or [float("nan")]
        at = lambda p: o[min(len(o) - 1, int(p * len(o)))]  # noqa: E731
        print(f"[profiler] {name}: {args.reads} reads in {r['s']:.1f} s, "
              f"{len(r['lost'])} lost a kernel {r['lost'][:10]}; first "
              f"kernel after the call (us): min {o[0]:.1f} p50 "
              f"{at(0.5):.1f} p99 {at(0.99):.1f} max {o[-1]:.1f}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
