"""Port parity: the SPMM's edge-weight gradient (SDDMM, fp32 and packed
residual) and the dequant-matmul against the JAX package.

The same numpy inputs go through the JAX kernels (interpret mode) and the
port's plain versions on the CPU. Packed residuals are the same bytes on
both sides. Both sides sum fp32 products in different orders, and the JAX
side may fuse ``code * scale + zero`` into one fma, so results agree to fp32
reassociation: max |diff| <= 1e-6 of max |ref|.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import csr as jcsr
from repro.kernels import dequant_matmul as jdqmm
from repro.kernels import spmm as jspmm
from repro.kernels.ref import ref_quant_pack
from repro_torch.core.quant import QTensor
from repro_torch.data import csr as tcsr
from repro_torch.kernels import ops as tops

TOL = 1e-6
N_SRC, N_DST, N_EDGES, DIM = 60, 70, 300, 37


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(5)
    src = rng.integers(0, N_SRC, N_EDGES)
    dst = rng.integers(0, 2 * N_DST // 3, N_EDGES)    # empty last tiles
    kw = dict(n_dst=N_DST, n_src=N_SRC, block_e=16, block_rows=8)
    lay_t = tcsr.build_spmm_layout(src, dst, device="cpu", **kw)
    assert (lay_t.perm_blk == N_EDGES).any()           # pad slots present
    return (jcsr.build_spmm_layout(src, dst, **kw), lay_t, src, dst,
            rng.normal(size=(N_SRC, DIM)).astype(np.float32),
            rng.normal(size=(N_DST, DIM)).astype(np.float32))


def test_sddmm_plain_matches_jax(graph):
    lay_j, lay_t, src, dst, x, g = graph
    ref = jspmm.sddmm_ew(jnp.asarray(x), jnp.asarray(g), lay_j, block_d=128,
                         interpret=True)
    got = tops.spmm_grad_ew(torch.from_numpy(x), torch.from_numpy(g),
                            lay_t).numpy()
    _close(got, ref)
    coo = np.einsum("ed,ed->e", x[src].astype(np.float64),
                    g[dst].astype(np.float64))
    _close(got, coo)


def _packed(x, bits):
    packed, scale, zero = (np.array(a) for a in ref_quant_pack(
        jnp.asarray(x), jnp.uint32(7), bits=bits, stochastic=True))
    q = QTensor(torch.from_numpy(packed), torch.from_numpy(scale),
                torch.from_numpy(zero), bits, x.shape[1])
    return packed, scale, zero, q


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_dequant_sddmm_plain_matches_jax(graph, bits):
    """Rows 6 and 7 of the kernel table compute one function: the port's
    plain version is held to the VMEM kernel, and at INT2 to the DMA one."""
    lay_j, lay_t, _, _, x, g = graph
    packed, scale, zero, q = _packed(x, bits)
    assert packed.shape[1] * (8 // bits) > DIM or bits == 8  # padded pack
    args = (jnp.asarray(packed), jnp.asarray(scale), jnp.asarray(zero),
            jnp.asarray(g), lay_j)
    got = tops.spmm_grad_ew(q, torch.from_numpy(g), lay_t).numpy()
    _close(got, jspmm.dequant_sddmm_ew(*args, bits=bits, dim=DIM,
                                       interpret=True))
    if bits == 2:
        _close(got, jspmm.dequant_sddmm_ew(*args, bits=bits, dim=DIM,
                                           dma=True, interpret=True))


@pytest.mark.parametrize("bits", [2, 8])
def test_dequant_matmul_plain_matches_jax(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(300, DIM)).astype(np.float32)
    g = rng.normal(size=(300, 24)).astype(np.float32)
    packed, scale, zero, q = _packed(x, bits)
    ref = jdqmm.dequant_matmul(jnp.asarray(packed), jnp.asarray(scale),
                               jnp.asarray(zero), jnp.asarray(g), bits=bits,
                               dim=DIM, interpret=True)
    got = tops.dequant_matmul(q, torch.from_numpy(g)).numpy()
    assert got.shape == (DIM, 24)
    _close(got, ref)
