"""Fused dequantize + transposed GEMM for the ACT weight gradient: CUDA
kernel and plain version.

Port of ``repro/kernels/dequant_matmul.py:dequant_matmul`` (TPU kernel
``_dqmm_kernel``) and its oracle ``repro/kernels/ref.py:ref_dequant_matmul``:
``dW = dequant(q)ᵀ @ g`` in fp32, the weight gradient ∇Θ = Ĥᵀ∇J of paper
Eq. (2), without writing ``x_hat`` to device memory. The kernel is
``csrc/dequant_matmul.cu``: R split across at most 264 CTAs, the products
on the bf16 tensor cores made exact (centred codes times a three-way bf16
split of ``scale * g``, fp32 sums), partial tiles summed in a fixed order
by a second pass; its source note says what bounds it.

``kernels.ops.dequant_matmul`` sends CUDA tensors to ``dequant_matmul_cuda``
and CPU tensors to ``dequant_matmul_plain``. The plain version rounds
``x_hat`` and runs one fp32 product; the kernel sums the exact products of
the codes and the zero term apart. They agree to fp32 reassociation: within
1e-5 of max |plain| (the card tests and ``chip_smoke.py`` hold them to it,
on rows offset far from 0 and on rows centred on 0 too).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QTensor, dequantize

from . import backend

__all__ = ["dequant_matmul_plain", "dequant_matmul_cuda",
           "dequant_matmul_cost"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P)


def dequant_matmul_cost(rows: int, dim: int, n: int,
                        dp: int) -> backend.KernelCost:
    """One ``dequant(q)ᵀ @ g`` of (rows, dp) packed rows and (rows, n) g:
    codes, scale, zero and g read once, the (dim, n) output written once;
    the three bf16 tensor-core products of the exact split (2·rows·dim·n
    operations each) at the bf16 rate."""
    return backend.KernelCost(3 * 2 * rows * dim * n,
                              rows * (dp + 8) + rows * n * 4 + dim * n * 4,
                              "bf16")


def dequant_matmul_plain(q: QTensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version (the ``ref_dequant_matmul`` oracle): dequantize, then
    an fp32 ``x_hatᵀ @ g``."""
    return dequantize(q).to(torch.float32).T @ g.to(torch.float32)


def dequant_matmul_cuda(q: QTensor, g: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/dequant_matmul.cu``: (rows, dp) packed and (rows, n)
    fp32 g -> (dim, n) fp32."""
    backend.check_cuda(q.packed, torch.uint8, 2, "packed")
    backend.check_cuda(q.scale, torch.float32, 2, "scale")
    backend.check_cuda(q.zero, torch.float32, 2, "zero")
    backend.check_cuda(g, torch.float32, 2, "g")
    backend.require_sm90(g.device)
    rows, dp = q.packed.shape
    if dp * (8 // q.bits) < q.dim or q.scale.shape != (rows, 1) \
            or q.zero.shape != (rows, 1) or g.shape[0] != rows:
        raise ValueError(f"packed table {tuple(q.packed.shape)} at "
                         f"{q.bits} bits, width {q.dim}, against g of shape "
                         f"{tuple(g.shape)}")
    n = g.shape[1]
    chunks = backend.kernel_fn("dequant_matmul", "dequant_matmul_chunks",
                               (_I, _I, _I))(rows, q.dim, n)
    partial = torch.empty((chunks, q.dim, n), dtype=torch.float32,
                          device=g.device)
    out = torch.empty((q.dim, n), dtype=torch.float32, device=g.device)
    fn = backend.kernel_fn("dequant_matmul", "dequant_matmul_launch",
                           _ARGTYPES)
    with torch.cuda.device(g.device):
        backend.launch(fn, q.packed.data_ptr(), dp, q.bits, q.dim,
                       q.scale.data_ptr(), q.zero.data_ptr(), g.data_ptr(),
                       rows, n, partial.data_ptr(), out.data_ptr(),
                       backend.stream_of(g))
    backend.count_launch("dequant_matmul")
    return out
