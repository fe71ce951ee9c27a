"""The dequant-matmul kernel's arithmetic, and the fused-gather dequantize,
on the CPU against the JAX package.

``csrc/dequant_matmul.cu`` runs ``dequant(q)ᵀ @ g`` on the bf16 tensor
cores: centred codes ``c - c0`` (``c0 = (2^b - 1) / 2``, a half-integer
with at most 8 significant bits: exact in bf16) times the three bf16 parts
of ``h = scale * g``, which sum to ``h`` exactly, so every product is exact
and only the fp32 sums round; the zero term ``sum_r fma(c0, s, z) * g`` is
an fp32 column sum beside them. ``_kernel_model`` below repeats that
arithmetic in torch, stage by stage and chunk by chunk as the kernel sums
(fp32 sums in another order inside a stage: the card's accumulation order
is the tensor cores'). It is a test helper only; the package never calls
it. It is held within 1e-5 (max |diff| / max |ref|) of the JAX package's
``dequant_matmul`` (the Pallas kernel in interpret mode) on random rows, on
rows offset far from 0 (the zero term dominates) and on rows centred on 0
with g of mixed sign (without the centre, the code and zero sums would
cancel).

``ops.dequantize_rows`` on the CPU (``dequantize(q.select(idx))``) is held
bit for bit against the reference's ``ref_dequant_unpack`` run eagerly on
the selected rows (op by op, no FMA contraction), and indexes as torch does
(negative indices count from the end; one out of range raises), which the
kernel follows on the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.dequant_matmul import dequant_matmul as jdqmm
from repro_torch.core.quant import QTensor, dequantize, quantize
from repro_torch.kernels import ops

ROWS_PER_STAGE = 64      # csrc/dequant_matmul.cu kRows
MAX_CTAS = 264           # kMaxCtas: partial tiles summed in chunk order


def _table(kind, rows, dim, n, bits, seed):
    """Rows of x quantized (nearest) and a gradient g, from numpy."""
    rng = np.random.default_rng(seed)
    if kind == "offset":        # x = 4 + 0.05 randn: z dominates c * s
        x = 4.0 + 0.05 * rng.standard_normal((rows, dim))
    elif kind == "cancel":      # rows centred on 0, g of mixed sign
        x = 0.1 * rng.standard_normal((rows, dim))
    else:
        x = rng.standard_normal((rows, dim))
    g = rng.standard_normal((rows, n)) * 1e-3
    q = quantize(torch.from_numpy(x.astype(np.float32)), bits=bits)
    return q, torch.from_numpy(g.astype(np.float32))


def _split3(h):
    """Three bf16 parts of fp32 ``h``, each remainder exact in fp32."""
    h1 = h.to(torch.bfloat16).float()
    r1 = h - h1
    h2 = r1.to(torch.bfloat16).float()
    h3 = (r1 - h2).to(torch.bfloat16).float()
    return h1, h2, h3


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _kernel_model(q: QTensor, g: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic for one 64 x 64 output tile (dim, n <= 64)."""
    from repro_torch.core.quant import unpack_bits

    rows = q.rows
    c0 = (2**q.bits - 1) / 2
    a = unpack_bits(q.packed, q.bits, q.dim).float() - c0
    s, z = q.scale.float(), q.zero.float()
    h = s * g
    zc = (c0 * s.double() + z.double()).float()            # fma(c0, s, z)
    parts = _split3(h)
    chunks = min(MAX_CTAS, _ceil(rows, ROWS_PER_STAGE))
    per = _ceil(_ceil(rows, chunks), ROWS_PER_STAGE) * ROWS_PER_STAGE
    out = torch.zeros((q.dim, g.shape[1]))
    for r0 in range(0, rows, per):
        acc = torch.zeros_like(out)
        zacc = torch.zeros(g.shape[1])
        for s0 in range(r0, min(rows, r0 + per), ROWS_PER_STAGE):
            sl = slice(s0, min(rows, r0 + per, s0 + ROWS_PER_STAGE))
            tmp = torch.zeros_like(out)
            for p in parts:
                tmp = tmp + a[sl].T @ p[sl]
            acc = acc + tmp
            zacc = zacc + (zc[sl] * g[sl]).sum(0)
        out = out + (acc + zacc[None, :])
    return out


def _jax(q: QTensor, g: torch.Tensor) -> np.ndarray:
    return np.asarray(jdqmm(jnp.asarray(q.packed.numpy()),
                            jnp.asarray(q.scale.numpy()),
                            jnp.asarray(q.zero.numpy()),
                            jnp.asarray(g.numpy()), bits=q.bits, dim=q.dim,
                            interpret=True))


@pytest.mark.parametrize("kind", ["randn", "offset", "cancel"])
@pytest.mark.parametrize("bits", [2, 8])
def test_split_products_match_jax_dequant_matmul(kind, bits):
    """R 65: two 64-row chunks (partial tiles), the second one row."""
    rows = 65
    q, g = _table(kind, rows, 64, 64, bits, rows + bits)
    # the claim: centred codes and the three parts are exact in bf16, and
    # the parts sum to h exactly
    c0 = (2**bits - 1) / 2
    codes = torch.arange(2**bits, dtype=torch.float32) - c0
    assert torch.equal(codes.to(torch.bfloat16).float(), codes)
    h = q.scale * g
    parts = _split3(h)
    for p in parts:
        assert torch.equal(p.to(torch.bfloat16).float(), p)
    assert torch.equal(parts[0].double() + parts[1].double()
                       + parts[2].double(), h.double())
    ref = _jax(q, g)
    got = _kernel_model(q, g).numpy()
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel <= 1e-5, rel
    # and the port's plain version, which rounds x_hat first
    plain = ops.dequant_matmul(q, g).numpy()
    assert np.abs(plain - ref).max() / np.abs(ref).max() <= 1e-5


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("dim", [64, 37])
def test_dequantize_rows_matches_reference_unpack(bits, dim):
    """Unsorted, duplicate int32 and int64 indices, and an empty index."""
    rng = np.random.default_rng(bits * dim)
    x = rng.standard_normal((50, dim)).astype(np.float32)
    q = quantize(torch.from_numpy(x), bits=bits)
    idx = rng.integers(0, 50, 80)
    idx[:5] = idx[5]
    for dtype in (torch.int32, torch.int64):
        got = ops.dequantize_rows(q, torch.from_numpy(idx).to(dtype))
        ref = jref.ref_dequant_unpack(jnp.asarray(q.packed.numpy()[idx]),
                                      jnp.asarray(q.scale.numpy()[idx]),
                                      jnp.asarray(q.zero.numpy()[idx]),
                                      bits=bits, dim=dim)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert torch.equal(got, dequantize(q)[torch.from_numpy(idx)])
    empty = ops.dequantize_rows(q, torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, dim)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_dequantize_rows_indexes_as_torch(dtype):
    """Negative indices count from the end; an index outside [-rows, rows)
    raises."""
    rng = np.random.default_rng(5)
    q = quantize(torch.from_numpy(
        rng.standard_normal((50, 64)).astype(np.float32)), bits=4)
    idx = torch.tensor([-1, -50, 0, 49], dtype=dtype)
    got = ops.dequantize_rows(q, idx)
    assert torch.equal(got, dequantize(q)[torch.tensor([49, 0, 0, 49])])
    for bad in (50, -51):
        with pytest.raises(IndexError):
            ops.dequantize_rows(q, torch.tensor([0, bad], dtype=dtype))
