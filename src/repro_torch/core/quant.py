"""Per-row uniform quantization and the chunk-interleaved bit-pack.

Quantize:   q = round((x - Z) / R * B)          with B = 2^b - 1 bins
Dequantize: x_hat = R * q / B + Z

Each row (last axis) gets its own range ``R = max - min`` and zero
``Z = min``. Codes of ``b`` bits are packed ``8 // b`` to a byte in the
chunk-interleaved layout of DESIGN.md section 2: the padded last axis of
``dp * cpb`` codes (``cpb = 8 // b``, ``dp = ceil(d / cpb)``) is split into
``cpb`` contiguous chunks, and byte ``j`` holds code ``k*dp + j`` in bits
``[k*b, (k+1)*b)``. The CUDA quantizer writes, and the CUDA top-K kernel
reads, exactly this layout.

``quantize`` routes through ``kernels.ops.quant_pack``: the CUDA kernel for
a tensor on the card, its plain version for one on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["QTensor", "quantize", "dequantize", "pack_bits", "unpack_bits",
           "act_bytes"]


@dataclasses.dataclass(frozen=True)
class QTensor:
    """A bit-packed quantized table.

    packed : uint8 ``(rows, ceil(d * bits / 8))``
    scale  : fp32 ``R / B`` per row, ``(rows, 1)``
    zero   : fp32 ``Z`` per row, ``(rows, 1)``
    bits   : 1, 2, 4 or 8
    dim    : the true last-axis size d (to strip pack padding)
    dtype  : the dtype ``dequantize`` restores
    """

    packed: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    dim: int
    dtype: torch.dtype = torch.float32

    @property
    def nbytes(self) -> int:
        return self.packed.numel() + (self.scale.numel()
                                      + self.zero.numel()) * 4

    @property
    def rows(self) -> int:
        return int(self.packed.shape[0])

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def select(self, idx) -> "QTensor":
        """The rows ``idx`` (an index tensor or a slice) as a QTensor."""
        return dataclasses.replace(self, packed=self.packed[idx],
                                   scale=self.scale[idx], zero=self.zero[idx])


def _codes_per_byte(bits: int) -> int:
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"unsupported bit-width {bits}")
    return 8 // bits


def pack_bits(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """``(..., d)`` uint8 codes (< 2^bits) -> ``(..., dp)`` packed uint8."""
    cpb = _codes_per_byte(bits)
    if cpb == 1:
        return codes
    d = codes.shape[-1]
    dp = -(-d // cpb)
    pad = dp * cpb - d
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    out = codes[..., 0:dp].clone()
    for k in range(1, cpb):
        out |= codes[..., k * dp:(k + 1) * dp] << (k * bits)
    return out


def unpack_bits(packed: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: uint8 codes with last axis ``dim``."""
    cpb = _codes_per_byte(bits)
    if cpb == 1:
        return packed[..., :dim]
    mask = 2**bits - 1
    chunks = [(packed >> (k * bits)) & mask for k in range(cpb)]
    return torch.cat(chunks, dim=-1)[..., :dim]


def quantize(x: torch.Tensor, seed: int = 0, *, bits: int = 8,
             stochastic: bool = False) -> QTensor:
    """Per-row quantize + pack a 2-D table.

    ``stochastic=False`` rounds to nearest (half to even, as ``jnp.round``).
    ``stochastic=True`` is the counter-hash stochastic rounding of
    ``repro/kernels/ref.py:ref_quant_pack``: the uniform for element
    ``(r, c)`` is ``hash_uniform(r*d + c, seed)``. The JAX package's jnp
    ``stochastic_round`` draws from ``jax.random`` instead, which no other
    framework reproduces, so the port has only the counter-hash form.
    """
    from repro_torch.kernels import ops

    if x.ndim != 2:
        raise ValueError(f"quantize takes a 2-D table, got {tuple(x.shape)}")
    packed, scale, zero = ops.quant_pack(x, seed, bits=bits,
                                         stochastic=stochastic)
    return QTensor(packed=packed, scale=scale, zero=zero, bits=bits,
                   dim=int(x.shape[-1]), dtype=x.dtype)


def dequantize(q: QTensor) -> torch.Tensor:
    """``x_hat = code * scale + zero`` (two roundings), in ``q.dtype``."""
    codes = unpack_bits(q.packed, q.bits, q.dim).to(torch.float32)
    return (codes * q.scale + q.zero).to(q.dtype)


def act_bytes(shape, bits: int | None, itemsize: int = 4) -> int:
    """Bytes to store an activation of ``shape`` at ``bits`` (None: the
    uncompressed fp32 baseline), the per-row scale and zero included."""
    n = 1
    for s in shape:
        n *= s
    if bits is None:
        return n * itemsize
    d = shape[-1]
    rows = n // d
    return rows * ((d * bits + 7) // 8) + rows * 2 * 4
