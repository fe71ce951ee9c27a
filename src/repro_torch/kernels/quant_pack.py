"""Fused per-row min/max + quantize + bit-pack, and its inverse unpack +
dequantize: CUDA kernels and plain versions.

Port of ``repro/kernels/quant_pack.py:_quant_kernel`` and
``_dequant_kernel`` (the TPU kernels, wrappers ``quant_pack`` and
``dequant_unpack``) and their oracles ``repro/kernels/ref.py:ref_quant_pack``
and ``ref_dequant_unpack``. The kernels are ``csrc/quant_pack.cu`` and
``csrc/dequant_unpack.cu``; their source notes say what bounds them on the
H100.

``kernels.ops.quant_pack`` sends a CUDA tensor to ``quant_pack_cuda`` and a
CPU tensor to ``quant_pack_plain``; both return ``(packed, scale, zero)``
with identical bits: the plain version keeps the kernel's fp32 operation
order. The kernel reads fp32 or bf16 rows (a bf16 row widens exactly in
registers, so its codes are its fp32 upcast's, as the TPU kernel casts to
fp32 inside); the plain version upcasts first.

``dequant_unpack_cuda`` and ``dequant_unpack_plain`` (``core.quant``'s
``dequantize``: unpack, then ``code * scale + zero`` with the product and
the sum rounded apart) agree bit for bit at every width, padded packs
included. Both take an optional row index ``idx`` (int32 or int64, shape
``(m,)``): ``out[i] = dequant(packed[idx[i]])``, the gather fused into the
kernel (the plain version selects the rows first). Both index as torch
does: a negative index counts from the end, and one outside ``[-rows,
rows)`` raises (on the card through a device-side assert, reported by the
next synchronising call, as torch's own indexing there).

Rounding of ``scale``: the reference writes ``R / B`` with the constant
``B = 2^b - 1``, and XLA compiles that (inside the Pallas kernel, or any
jitted caller) into ``R * fl(1/B)``, a multiply by the float32-rounded
reciprocal. Only an eager, op-by-op run of ``ref_quant_pack`` divides. The
port keeps the compiled rounding, so its packed stores are bit-identical to
the JAX package's.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QTensor, dequantize, pack_bits

from . import backend
from .hashrng import hash_uniform

__all__ = ["quant_pack_plain", "quant_pack_cuda", "quant_pack_plan",
           "quant_pack_cost", "dequant_unpack_plain", "dequant_unpack_cuda",
           "dequant_unpack_cost"]

_EPS = 1e-12
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _I, _I, _I, _I, ctypes.c_uint, _P, _P, _P, _P)
_PLAN_ARGTYPES = (_I, _I, _I, _I, _I, _P)
# the C entry a dtype of x launches
_ENTRY = {torch.float32: "quant_pack_launch",
          torch.bfloat16: "quant_pack_launch_bf16"}
_PLAN_KEYS = ("route", "rows_a_tile", "stages", "stage_floats", "smem",
              "tiles", "lanes_a_row", "grid")
_DQ_ARGTYPES = (_P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P)


def quant_pack_plain(x: torch.Tensor, seed: int, *, bits: int,
                     stochastic: bool = True):
    """Plain PyTorch version (the ``ref_quant_pack`` oracle)."""
    rows, d = x.shape
    xf = x.to(torch.float32)
    lo = xf.amin(dim=-1, keepdim=True)
    hi = xf.amax(dim=-1, keepdim=True)
    rng = hi - lo
    bins = torch.full_like(rng, float(2**bits - 1))
    # tensor / tensor: a true division on every device (a python scalar
    # divisor may be applied as a multiply by its reciprocal)
    normed = (xf - lo) * (bins / torch.clamp_min(rng, _EPS))
    if stochastic:
        gidx = (torch.arange(rows, dtype=torch.int64, device=x.device)[:, None]
                * d + torch.arange(d, dtype=torch.int64, device=x.device))
        u = hash_uniform(gidx, seed)
        floor = torch.floor(normed)
        codes_f = floor + (u < (normed - floor)).to(torch.float32)
    else:
        codes_f = torch.round(normed)       # half to even, as jnp.round
    codes = torch.minimum(torch.clamp_min(codes_f, 0.0), bins)
    recip = torch.full_like(rng, _recip(bits))
    return pack_bits(codes.to(torch.uint8), bits), rng * recip, lo


def _recip(bits: int) -> float:
    """fl32(1 / (2^bits - 1)), the constant XLA multiplies by for R / B."""
    return float(torch.tensor(1.0) / torch.tensor(float(2**bits - 1)))


def quant_pack_cuda(x: torch.Tensor, seed: int, *, bits: int,
                    stochastic: bool = True):
    """Launch ``csrc/quant_pack.cu`` on a contiguous fp32 or bf16 CUDA
    table (at any base: a row slice of a larger table needs no copy)."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    backend.check_cuda(x, x.dtype, 2, "x")
    backend.require_sm90(x.device)
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"unsupported bit-width {bits}")
    rows, d = x.shape
    dp = -(-d // (8 // bits))
    packed = torch.empty((rows, dp), dtype=torch.uint8, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    zero = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    fn = backend.kernel_fn("quant_pack", _ENTRY[x.dtype], _ARGTYPES)
    with torch.cuda.device(x.device):
        backend.launch(fn, x.data_ptr(), rows, d, bits, int(stochastic),
                       int(seed) & 0xFFFFFFFF, packed.data_ptr(),
                       scale.data_ptr(), zero.data_ptr(), backend.stream_of(x))
    backend.count_launch("quant_pack")
    return packed, scale, zero


def quant_pack_cost(rows: int, d: int, *, bits: int,
                    itemsize: int = 4) -> backend.KernelCost:
    """One quant-pack of a (rows, d) table of ``itemsize``-byte floats: the
    table read once, codes, scale and zero written once; 7 fp32 operations
    an element (min, max, scale, round, clamp, shift, or)."""
    dp = -(-d // (8 // bits))
    return backend.KernelCost(7 * rows * d,
                              rows * d * itemsize + rows * (dp + 8), "fp32")


def quant_pack_plan(rows: int, d: int, *, bits: int, stochastic: bool = True,
                    dtype: torch.dtype = torch.float32) -> dict:
    """The plan ``csrc/quant_pack.cu`` follows for a (rows, d) table of
    ``dtype`` on the current card: ``route`` "tiles" (rows a tile, stage
    buffers, elements a buffer, dynamic shared memory, tiles, lanes a row
    in the min/max) or "rows" (a block a row, for rows wider than two
    stage buffers), and the grid its launch takes."""
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"unsupported bit-width {bits}")
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    fn = backend.kernel_fn("quant_pack", "quant_pack_plan", _PLAN_ARGTYPES)
    backend.launch(fn, rows, d, bits, int(stochastic),
                   int(dtype == torch.bfloat16), ctypes.addressof(out))
    plan = dict(zip(_PLAN_KEYS, out))
    plan["route"] = ("tiles", "rows")[plan["route"]]
    return plan


def dequant_unpack_plain(packed: torch.Tensor, scale: torch.Tensor,
                         zero: torch.Tensor, *, bits: int, dim: int,
                         idx: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version (the ``ref_dequant_unpack`` oracle, which is
    ``core.quant.dequantize``): (rows, dp) uint8 -> (rows, dim) fp32, the
    pad sliced off; with ``idx``, the rows ``idx`` selected first."""
    q = QTensor(packed, scale, zero, bits, dim)
    return dequantize(q if idx is None else q.select(idx.long()))


def dequant_unpack_cuda(packed: torch.Tensor, scale: torch.Tensor,
                        zero: torch.Tensor, *, bits: int, dim: int,
                        idx: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/dequant_unpack.cu`` on a (rows, dp) packed CUDA table:
    every row, or the rows ``idx`` ((m,) int32 or int64) gathered in the
    kernel."""
    backend.check_cuda(packed, torch.uint8, 2, "packed")
    backend.check_cuda(scale, torch.float32, 2, "scale")
    backend.check_cuda(zero, torch.float32, 2, "zero")
    backend.require_sm90(packed.device)
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"unsupported bit-width {bits}")
    rows, dp = packed.shape
    if dp * (8 // bits) < dim or scale.shape != (rows, 1) \
            or zero.shape != (rows, 1):
        raise ValueError(f"packed {tuple(packed.shape)} at {bits} bits, "
                         f"scale {tuple(scale.shape)}, zero "
                         f"{tuple(zero.shape)} do not hold {rows} rows of "
                         f"{dim}")
    m = rows
    if idx is not None:
        if idx.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
        backend.check_cuda(idx, idx.dtype, 1, "idx")
        if idx.device != packed.device:
            raise ValueError(f"idx on {idx.device}, table on {packed.device}")
        m = idx.shape[0]
    out = torch.empty((m, dim), dtype=torch.float32, device=packed.device)
    fn = backend.kernel_fn("dequant_unpack", "dequant_unpack_launch",
                           _DQ_ARGTYPES)
    with torch.cuda.device(packed.device):
        backend.launch(fn, packed.data_ptr(), rows, dp, bits, dim,
                       scale.data_ptr(), zero.data_ptr(),
                       None if idx is None else idx.data_ptr(),
                       int(idx is not None and idx.dtype == torch.int64), m,
                       out.data_ptr(), backend.stream_of(packed))
    if out.numel():                  # the C entry launches nothing if empty
        backend.count_launch("dequant_unpack")
    return out


def dequant_unpack_cost(rows: int, d: int, dp: int, *,
                        idx_bytes: int = 0) -> backend.KernelCost:
    """One unpack of ``rows`` packed rows of ``dp`` bytes (gathered through
    an index of ``idx_bytes`` a row, or every row): codes, scale and zero
    (and the index) read once, the (rows, d) fp32 output written once; a
    multiply and an add an element."""
    return backend.KernelCost(2 * rows * d,
                              rows * (dp + 8 + idx_bytes) + rows * d * 4,
                              "fp32")
