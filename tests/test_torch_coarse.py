"""Port parity: two-stage retrieval's query quantizer, coarse scan, re-rank,
and the dequant-unpack route, against the JAX package.

Bit-exact where the reference is: ``q8`` and ``qs`` always; coarse values and
indices on integer-valued inputs full of ties (every product and sum is
exact, and with zero offsets XLA's fused multiply-add rounds as the port's
two roundings do); the integer two-stage anchor, values included. On random
inputs the coarse values agree within 1e-6 relative (XLA may contract the
affine step into an FMA; the port rounds the products and the sum apart, as
its kernel does) and indices are equal except between scores within that
tolerance. Dequantized values agree within one ulp (XLA on the CPU fuses
``code * scale + zero``), bit for bit on integer-valued scale and zero.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QTensor as JQ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import topk_score as jtk
from repro.serving import scorer as jsc
from repro.serving import store as jstore
from repro_torch.core.quant import QTensor as TQ
from repro_torch.core.quant import pack_bits
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_pack as tqp
from repro_torch.kernels import topk_score as ttk
from repro_torch.serving import scorer as tsc
from repro_torch.serving import store as tstore

U, I, D, K = 16, 257, 64, 20     # I not a multiple of any chunk size


def _tables(n_items, d, bits, seed, *, integer):
    """The same packed table on both sides; ``integer``: codes in [0, 3],
    scale 1, zero 0 (massive score ties)."""
    rng = np.random.default_rng(seed)
    hi = 4 if integer else 2**bits
    codes = rng.integers(0, hi, (n_items, d)).astype(np.uint8)
    if integer:
        scale = np.ones((n_items, 1), np.float32)
        zero = np.zeros((n_items, 1), np.float32)
    else:
        scale = rng.uniform(0.01, 0.05, (n_items, 1)).astype(np.float32)
        zero = rng.uniform(-1, 0, (n_items, 1)).astype(np.float32)
    packed = pack_bits(torch.from_numpy(codes), bits).numpy()
    tq = TQ(torch.from_numpy(packed), torch.from_numpy(scale),
            torch.from_numpy(zero), bits, d)
    jq = JQ(jnp.asarray(packed), jnp.asarray(scale), jnp.asarray(zero), bits,
            d, jnp.float32)
    return tq, jq


def _queries(b, d, seed, *, integer):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-3, 4, (b, d)).astype(np.float32)
    return rng.normal(size=(b, d)).astype(np.float32)


def _excl(b, n_items, seed):
    rng = np.random.default_rng(seed)
    ex = rng.integers(0, n_items, (b, 7)).astype(np.int32)
    ex[:, 5:] = -1                                   # pads
    ex[0, :] = -1                                    # a row with none
    return ex


def _assert_close(tv, ti, jv, ji, rel=1e-6):
    tv, ti, jv, ji = (np.asarray(a) for a in (tv, ti, jv, ji))
    tol = rel * float(np.abs(jv[np.isfinite(jv)]).max())
    np.testing.assert_allclose(tv, jv, rtol=0, atol=tol)
    swapped = ti != ji
    assert (np.abs(tv - jv)[swapped] <= tol).all()


@pytest.mark.parametrize("integer", [False, True])
def test_quantize_query_matches_jax(integer):
    q = _queries(300, D, 1, integer=integer)
    q[3] = 0.0                                       # the 1e-12 floor
    jq8, jmeta = (np.asarray(a) for a in jsc.quantize_query(jnp.asarray(q)))
    tq8, tmeta = (a.numpy() for a in tsc.quantize_query(torch.from_numpy(q)))
    np.testing.assert_array_equal(tq8, jq8)
    np.testing.assert_array_equal(tmeta[:, 0], jmeta[:, 0])
    if integer:
        np.testing.assert_array_equal(tmeta[:, 1], jmeta[:, 1])
    else:
        # two summation orders: within one ulp of sum |q|, the scale of the
        # reassociation error (the sums themselves cancel towards 0)
        ulp = np.spacing(np.abs(q).sum(-1).astype(np.float32))
        assert (np.abs(tmeta[:, 1] - jmeta[:, 1]) <= ulp).all()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block_i", [40, 257])
def test_coarse_ties_bit_identical_to_jax(bits, block_i):
    tq, jq = _tables(I, D, bits, bits, integer=True)
    q = _queries(U, D, 2, integer=True)
    ex = _excl(U, I, 3)
    jv, ji = jsc.coarse_topm(jnp.asarray(q), jq, 37, exclude=jnp.asarray(ex),
                             backend="jnp", block_i=block_i)
    q8, qmeta = tsc.quantize_query(torch.from_numpy(q))
    tv, ti = ttk.coarse_topm_plain(q8, qmeta, tq, torch.from_numpy(ex), m=37,
                                   block_i=block_i)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not (ti.numpy()[:, :, None] == ex[:, None, :]).any()
    # the scorer's route (default chunk) gives the same lossless result
    sv, si = tsc.coarse_topm(torch.from_numpy(q), tq, 37,
                             exclude=torch.from_numpy(ex))
    assert torch.equal(si, ti) and torch.equal(sv, tv)


@pytest.mark.parametrize("bits", [8, 4])
def test_coarse_random_close_to_jax(bits):
    rng = np.random.default_rng(4)
    items = rng.normal(size=(I, D)).astype(np.float32)
    js = jstore.QuantizedEmbeddingStore.from_arrays(
        jnp.asarray(items[:U]), jnp.asarray(items), bits=bits)
    ts = tstore.QuantizedEmbeddingStore.from_arrays(
        torch.from_numpy(items[:U]), torch.from_numpy(items), bits=bits)
    q = _queries(U, D, 5, integer=False)
    ex = _excl(U, I, 6)
    jv, ji = jsc.coarse_topm(jnp.asarray(q), js.items, 80,
                             exclude=jnp.asarray(ex), backend="jnp",
                             block_i=128)
    tv, ti = tsc.coarse_topm(torch.from_numpy(q), ts.items, 80,
                             exclude=torch.from_numpy(ex))
    _assert_close(tv.numpy(), ti.numpy(), jv, ji)


def test_coarse_matches_interpret_kernel():
    """One tiny case through the Pallas coarse kernel (interpret mode)."""
    tq, jq = _tables(I, 16, 8, 7, integer=True)
    q = _queries(4, 16, 8, integer=True)
    ex = _excl(4, I, 9)
    q8, qmeta = jsc.quantize_query(jnp.asarray(q))
    jv, ji = jtk.fused_coarse_topm(
        q8, qmeta, jq.packed, jq.scale, jq.zero, jnp.asarray(ex), bits=8,
        dim=16, m=30, n_items=I, block_i=128, interpret=True)
    tv, ti = tsc.coarse_topm(torch.from_numpy(q), tq, 30,
                             exclude=torch.from_numpy(ex))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _stores(bits=8):
    rng = np.random.default_rng(7)
    users = rng.normal(size=(U, D)).astype(np.float32)
    items = rng.normal(size=(I, D)).astype(np.float32)
    js = jstore.QuantizedEmbeddingStore.from_arrays(
        jnp.asarray(users), jnp.asarray(items), bits=bits,
        quantize_users=False)
    ts = tstore.QuantizedEmbeddingStore.from_arrays(
        torch.from_numpy(users), torch.from_numpy(items), bits=bits,
        quantize_users=False)
    return users, js, ts


@pytest.mark.parametrize("c", [4, -(-I // K)])
def test_two_stage_matches_jax(c):
    """C 4 against the JAX two-stage path; at the anchor C = ceil(I/k)
    every item is a candidate and the indices equal the single stage's."""
    users, js, ts = _stores()
    ex = _excl(U, I, 10)
    jv, ji = jsc.two_stage_topk(jnp.asarray(users), js.items, K, c=c,
                                exclude=jnp.asarray(ex), backend="jnp")
    tv, ti = tsc.two_stage_topk(torch.from_numpy(users), ts.items, K, c=c,
                                exclude=torch.from_numpy(ex))
    _assert_close(tv.numpy(), ti.numpy(), jv, ji)
    if c * K >= I:
        sv, si = tsc.topk_scores(torch.from_numpy(users), ts.items, K,
                                 exclude=torch.from_numpy(ex))
        np.testing.assert_array_equal(ti.numpy(), si.numpy())
        np.testing.assert_allclose(tv.numpy(), sv.numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert not (ti.numpy()[:, :, None] == ex[:, None, :]).any()


def test_two_stage_anchor_bit_identical_integer_embeddings():
    """As the reference's integer anchor: rows spanning [0, 255] survive
    INT8 exactly, every path is exact integer arithmetic, so the C -> n/k
    anchor equals the single stage bit for bit, values included, in both
    packages."""
    rng = np.random.default_rng(5)
    q = rng.integers(-3, 4, (7, 16)).astype(np.float32)
    items = (255 * rng.integers(0, 2, (83, 16))).astype(np.float32)
    items[:, 0], items[:, 1] = 0.0, 255.0
    js = jstore.QuantizedEmbeddingStore.from_arrays(
        jnp.asarray(q), jnp.asarray(items), bits=8, quantize_users=False)
    ts = tstore.QuantizedEmbeddingStore.from_arrays(
        torch.from_numpy(q), torch.from_numpy(items), bits=8,
        quantize_users=False)
    jv, ji = jsc.two_stage_topk(jnp.asarray(q), js.items, 10, c=9,
                                backend="jnp")
    tv, ti = tsc.two_stage_topk(torch.from_numpy(q), ts.items, 10, c=9)
    sv, si = tsc.topk_scores(torch.from_numpy(q), ts.items, 10)
    for v, i in ((jv, ji), (sv, si)):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(i))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(v))


def test_two_stage_needs_packed_items():
    users, _, ts = _stores()
    with pytest.raises(ValueError, match="packed"):
        tsc.two_stage_topk(torch.from_numpy(users),
                           torch.from_numpy(users), 3)


@pytest.mark.parametrize("bits,d,integer", [(8, 64, False), (4, 64, True),
                                             (2, 37, False), (1, 37, True)])
def test_dequantize_matches_jax(bits, d, integer):
    """The port's dequantize route on the CPU (the plain dequant-unpack)
    against the JAX package's ``kernels/ops.dequantize`` (the Pallas kernel
    in interpret mode) and its oracle ``ref_dequant_unpack``. XLA fuses
    ``code * scale + zero`` into one FMA, the port rounds the product
    apart: within one ulp of the larger of the result and the offset (the
    product's rounding), bit for bit on integer-valued scale and zero."""
    tq, jq = _tables(33, d, bits, bits + d, integer=False)
    if integer:                    # scale and zero small integers
        rng = np.random.default_rng(d)
        scale = rng.integers(1, 4, (33, 1)).astype(np.float32)
        zero = rng.integers(-5, 5, (33, 1)).astype(np.float32)
        tq = TQ(tq.packed, torch.from_numpy(scale), torch.from_numpy(zero),
                bits, d)
        jq = JQ(jq.packed, jnp.asarray(scale), jnp.asarray(zero), bits, d,
                jnp.float32)
    got = tops.dequantize(tq).numpy()
    assert got.shape == (33, d)
    np.testing.assert_array_equal(
        got, tqp.dequant_unpack_plain(tq.packed, tq.scale, tq.zero,
                                      bits=bits, dim=d).numpy())
    for ref in (jops.dequantize(jq),
                jref.ref_dequant_unpack(jq.packed, jq.scale, jq.zero,
                                        bits=bits, dim=d)):
        ref = np.asarray(ref)
        if integer:
            np.testing.assert_array_equal(got, ref)
        else:
            ulp = np.spacing(np.maximum(np.abs(ref), np.abs(jq.zero)))
            assert (np.abs(got - ref) <= ulp).all()


def test_topk_plain_takes_k_past_128():
    """The single-stage top-K at k 200 (the CUDA kernel's k limit is
    gone; its plain version never had one)."""
    tq, jq = _tables(I, 16, 8, 11, integer=True)
    q = _queries(5, 16, 12, integer=True)
    ex = _excl(5, I, 13)
    jv, ji = jsc.topk_scores(jnp.asarray(q), jq, 200, exclude=jnp.asarray(ex),
                             backend="jnp", block_i=64)
    tv, ti = tsc.topk_scores(torch.from_numpy(q), tq, 200,
                             exclude=torch.from_numpy(ex))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("b", [1, 3, 8, 33])
@pytest.mark.parametrize("m", [1, 80, 129, I])
def test_coarse_plain_ragged_ties_identical_to_jax(b, m):
    """The plain coarse scan (what the kernel is held to on the card) at
    ragged B and m across 1..n_items, on integer-valued ties with duplicate
    exclusions and a whole excluded 128-item tile: identical to the JAX
    package."""
    tq, jq = _tables(I, D, 4, b + m, integer=True)
    q = _queries(b, D, b * m, integer=True)
    ex = np.full((b, 130), -1, np.int32)
    ex[:, :7] = _excl(b, I, m)
    ex[0, :6] = [5, 5, 90, 90, 0, 0]
    if b > 1:
        ex[1, :128] = np.arange(128, 256)
    jv, ji = jsc.coarse_topm(jnp.asarray(q), jq, m, exclude=jnp.asarray(ex),
                             backend="jnp", block_i=128)
    q8, qmeta = tsc.quantize_query(torch.from_numpy(q))
    tv, ti = ttk.coarse_topm_plain(q8, qmeta, tq, torch.from_numpy(ex), m=m,
                                   block_i=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
