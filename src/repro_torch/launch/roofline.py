"""Roofline terms of one traced training step on the card (port of
``repro/launch/roofline.py``).

The reference parses the compiled HLO of a step. PyTorch compiles no HLO,
so ``trace_step(fn, *args, hw=...)`` runs one step and counts what it does,
each part standing in for a part of ``parse_hlo``:

  * compute term     : the FLOPs of the aten ops, by
    ``torch.utils.flop_counter.FlopCounterMode`` (2·M·N·K a matmul), plus
    each hand-written kernel's, which ``kernels.ops`` reports at every
    call (``obs.cost``; the kernel module's cost function of the call's
    shapes, as ``chip_smoke.py``'s bound column counts it);
  * memory term      : Σ result bytes × 2 (read + write proxy) of every
    aten op outside the hand-written kernels, through a
    ``TorchDispatchMode``, skipping views, aliases, copies that keep the
    dtype and allocations as the reference skips plumbing; plus the
    kernels' own bytes, each input read once and each output written once;
  * collective term  : the reference's per-kind byte model over the result
    bytes ``sharding.comm`` reports at each collective, the group size from
    the mesh axes:
      all-reduce      2·S·(G-1)/G     (ring: reduce-scatter + all-gather)
      all-gather      S·(G-1)/G
      reduce-scatter  S·(G-1)         (operand = G · result)
      all-to-all      S·(G-1)/G
      collective-permute  S

``roofline_terms`` is the reference's function. Profiles: ``"h100"`` is
NVIDIA's published dense peaks of the H100 SXM at 700 W (989 TFLOP/s bf16,
the profile's ``peak_flops``; 1,979 TOP/s int8; 495 TFLOP/s TF32; 67
TFLOP/s fp32 outside the tensor cores; HBM3 3.35 TB/s; NVLink 450 GB/s each
way as the link term), ``"host"`` the reference's CPU envelope. The port
carries no TPU profile. ``kernel_bound_ms`` is the least time a kernel call
can take on a profile: the larger of its bytes over the memory rate and its
operations over the rate of their type.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.obs import cost as _cost

__all__ = ["HW_PROFILES", "get_hw", "StepStats", "TracedStep",
           "roofline_terms", "collective_moved", "kernel_bound_ms",
           "trace_step", "COLLECTIVES"]

HW_PROFILES = {
    "h100": {
        "peak_flops": 989e12,   # dense bf16 tensor cores
        "hbm_bw": 3.35e12,      # HBM3, bytes/s
        "ici_bw": 450e9,        # NVLink 4, bytes/s each way
        "peak_bf16": 989e12,
        "peak_int8": 1979e12,   # dense int8 tensor cores, ops/s
        "peak_tf32": 495e12,
        "peak_fp32": 67e12,     # outside the tensor cores
    },
    "host": {
        "peak_flops": 0.2e12,   # few-core AVX2 envelope
        "hbm_bw": 20e9,         # DDR4 single-socket envelope
        "ici_bw": 5e9,          # loopback/PCIe stand-in
        "peak_bf16": 0.2e12,
        "peak_int8": 0.2e12,
        "peak_tf32": 0.2e12,
        "peak_fp32": 0.2e12,
    },
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def get_hw(name: str) -> dict:
    """Resolve a ``--hw`` profile name; KeyError lists the choices."""
    try:
        return HW_PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown hw profile {name!r}; "
                       f"choose from {sorted(HW_PROFILES)}") from None


@dataclasses.dataclass
class StepStats:
    """The reference's ``HLOStats``, counted from a traced step."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    per_kind: dict = dataclasses.field(default_factory=dict)
    n_collectives: int = 0


def collective_moved(kind: str, nbytes: float, group: int) -> float:
    """Bytes a collective of ``kind`` with a result of ``nbytes`` over
    ``group`` ranks moves, by the reference's per-kind model."""
    g = max(group, 1)
    if kind == "all-reduce":
        return 2.0 * nbytes * (group - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return nbytes * (group - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (group - 1)
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {kind!r}; one of {COLLECTIVES}")


def roofline_terms(stats: StepStats, *, model_flops_per_device: float = 0.0,
                   hw: dict = HW_PROFILES["h100"]) -> dict:
    """The three per-device roofline terms in seconds + the bottleneck."""
    compute_s = stats.flops / hw["peak_flops"]
    memory_s = stats.hbm_bytes / hw["hbm_bw"]
    collective_s = stats.collective_bytes / hw["ici_bw"]
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    useful = (model_flops_per_device / stats.flops
              if stats.flops > 0 and model_flops_per_device else None)
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "hlo_flops": stats.flops,
        "hlo_bytes": stats.hbm_bytes,
        "collective_bytes": stats.collective_bytes,
        "per_kind": stats.per_kind,
        "model_flops_ratio": useful,
        "roofline_fraction": (compute_s / bound) if bound > 0 else None,
    }


def kernel_bound_ms(c, hw: dict) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time one call of cost ``c``
    (a ``kernels.backend.KernelCost``) takes on ``hw``."""
    t_b = c.bytes / hw["hbm_bw"] * 1e3
    t_o = c.flops / hw[f"peak_{c.peak}"] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


_aten = torch.ops.aten
# results that are no memory traffic: views and aliases of their inputs,
# allocations, host reads, copies that keep the dtype (the reference's
# "copy"/"bitcast"/"parameter" plumbing)
_PLUMBING = {_aten.detach, _aten.alias, _aten.lift_fresh, _aten._unsafe_view,
             _aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided, _aten.set_,
             _aten.resize_, _aten._local_scalar_dense, _aten.record_stream}
_COPIES = {_aten.copy_, _aten.clone, _aten._to_copy}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _result_bytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(out))


class _Counter(torch.utils._python_dispatch.TorchDispatchMode):
    """The memory term's aten ops and the reports of ``obs.cost``."""

    def __init__(self):
        super().__init__()
        self.aten_bytes = 0.0
        self.kernels: dict = {}         # name -> [calls, flops, bytes]
        self.stats = StepStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if func.is_view or packet in _PLUMBING \
                or func.namespace in ("c10d", "_c10d_functional"):
            return out
        if packet in _COPIES:
            src = next(_tensors(args), None)
            res = next(_tensors(out), None)
            if src is None or res is None or src.dtype == res.dtype:
                return out
        self.aten_bytes += 2.0 * _result_bytes(out)
        return out

    # obs.cost listener
    def kernel(self, name: str, c) -> None:
        k = self.kernels.setdefault(name, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += c.flops
        k[2] += c.bytes

    def collective(self, kind: str, nbytes: int, group: int) -> None:
        moved = collective_moved(kind, nbytes, group)
        s = self.stats
        s.collective_bytes += moved
        s.per_kind[kind] = s.per_kind.get(kind, 0.0) + moved
        s.n_collectives += 1


@dataclasses.dataclass
class TracedStep:
    """What ``trace_step`` counted: the step's result ``out``, its
    ``stats``, their ``terms`` on the profile, the aten ops' FLOPs and
    bytes, and by kernel name ``[calls, flops, bytes]``."""

    out: object
    stats: StepStats
    terms: dict
    aten_flops: float
    aten_bytes: float
    kernels: dict


def trace_step(fn, *args, hw="h100", **kw) -> TracedStep:
    """Run ``fn(*args, **kw)`` once (one training step) and count its
    FLOPs, bytes and collective bytes (module docstring); ``hw`` a profile
    name or dict prices them."""
    from torch.utils.flop_counter import FlopCounterMode

    hw = get_hw(hw) if isinstance(hw, str) else hw
    counter = _Counter()
    flops = FlopCounterMode(display=False)
    with _cost.listen(counter), flops, counter:
        out = fn(*args, **kw)
    aten_flops = float(flops.get_total_flops())
    s = counter.stats
    s.flops = aten_flops + sum(k[1] for k in counter.kernels.values())
    s.hbm_bytes = counter.aten_bytes + sum(k[2]
                                           for k in counter.kernels.values())
    return TracedStep(out=out, stats=s, terms=roofline_terms(s, hw=hw),
                      aten_flops=aten_flops, aten_bytes=counter.aten_bytes,
                      kernels=counter.kernels)

