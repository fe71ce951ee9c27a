"""Port parity: hash, pack layout and quantizer against the JAX package.

The same numpy inputs go through the JAX reference and the PyTorch port on
the CPU. Codes, scale and zero must be bit-identical (the reference's own
contract between its kernel and ``ref_quant_pack``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import hashrng as jhash
from repro.kernels import quant_pack as jqp
from repro.kernels.ref import ref_quant_pack
from repro_torch.core import quant as tq
from repro_torch.kernels import hashrng as thash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_pack as tqp


def _x(rows, d, seed):
    return np.random.default_rng(seed).normal(size=(rows, d)).astype(
        np.float32) * 3.0


def test_hash_uniform_bit_identical():
    rng = np.random.default_rng(0)
    idx = np.concatenate([np.arange(4096, dtype=np.uint32),
                          rng.integers(0, 2**32, 4096, dtype=np.uint64)
                          .astype(np.uint32),
                          np.array([2**32 - 1, 2**31], np.uint32)])
    for seed in (0, 1, 0xDEADBEEF, 2**32 - 1):
        ref = np.asarray(jhash.hash_uniform(jnp.asarray(idx),
                                            jnp.uint32(seed)))
        got = thash.hash_uniform(torch.from_numpy(idx.astype(np.int64)),
                                 seed).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_unpack_layout_matches_jax(bits):
    rng = np.random.default_rng(bits)
    for d in (16, 13):
        codes = rng.integers(0, 2**bits, (5, d)).astype(np.uint8)
        ref = np.asarray(jq.pack_bits(jnp.asarray(codes), bits))
        got = tq.pack_bits(torch.from_numpy(codes), bits)
        np.testing.assert_array_equal(got.numpy(), ref)
        back = tq.unpack_bits(got, bits, d).numpy()
        np.testing.assert_array_equal(back, codes)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("d", [32, 37, 16, 100, 602])
def test_quant_pack_bit_identical_to_ref(bits, stochastic, d):
    """The oracle runs compiled, as every JAX caller runs it: XLA turns its
    ``R / B`` into ``R * fl(1/B)``, and so does the port (an eager run of
    the oracle divides, one ulp of ``scale`` away)."""
    x = _x(19, d, bits * 100 + d)
    x[3] = 1.25                                  # constant row: R == 0
    seed = 0x9E3779B9
    oracle = jax.jit(functools.partial(ref_quant_pack, bits=bits,
                                       stochastic=stochastic))
    p_ref, s_ref, z_ref = oracle(jnp.asarray(x), jnp.uint32(seed))
    p, s, z = tqp.quant_pack_plain(torch.from_numpy(x), seed, bits=bits,
                                    stochastic=stochastic)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_ref))


@pytest.mark.parametrize("bits,stochastic", [(4, True), (2, False)])
def test_quant_pack_matches_interpret_kernel(bits, stochastic):
    """One tiny case through the Pallas kernel itself (interpret mode),
    with a padded odd width and a partial row block."""
    x = _x(10, 21, 7)
    seed = 12345
    p_ref, s_ref, z_ref = jqp.quant_pack(
        jnp.asarray(x), jnp.uint32(seed), bits=bits, stochastic=stochastic,
        block_r=8, interpret=True)
    p, s, z = tops.quant_pack(torch.from_numpy(x), seed, bits=bits,
                              stochastic=stochastic)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_ref))


def test_dequantize_matches_jax():
    x = _x(12, 24, 3)
    q = tq.quantize(torch.from_numpy(x), 0, bits=4)
    jqt = jq.QTensor(packed=jnp.asarray(q.packed.numpy()),
                     scale=jnp.asarray(q.scale.numpy()),
                     zero=jnp.asarray(q.zero.numpy()), bits=4, dim=24,
                     dtype=jnp.float32)
    # XLA fuses code*scale + zero into one fma on the CPU; the port rounds
    # the product and the sum apart, as its CUDA top-K kernel does
    np.testing.assert_allclose(tq.dequantize(q).numpy(),
                               np.asarray(jq.dequantize(jqt)),
                               rtol=0, atol=2e-6)   # one ulp at |x| < 16
    assert q.nbytes == jqt.nbytes
