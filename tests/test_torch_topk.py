"""Port parity: the top-K scorer against the JAX package.

Indices must be identical on integer-valued inputs full of ties (every
product and sum is exact, so only the (value desc, index asc) order decides),
with exclusions; values within 1e-6 on random inputs, where the two dot
products sum in different orders.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QTensor as JQ
from repro.kernels import topk_score as jtk
from repro.serving import scorer as jsc
from repro_torch.core.quant import QTensor as TQ
from repro_torch.core.quant import pack_bits
from repro_torch.kernels import topk_score as ttk
from repro_torch.serving import scorer as tsc


def _tables(n_items, d, bits, seed, *, integer):
    rng = np.random.default_rng(seed)
    if integer:
        codes = rng.integers(0, 4, (n_items, d)).astype(np.uint8)
        scale = np.ones((n_items, 1), np.float32)
        zero = np.zeros((n_items, 1), np.float32)
    else:
        codes = rng.integers(0, 2**bits, (n_items, d)).astype(np.uint8)
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
        return rng.integers(-2, 3, (b, d)).astype(np.float32)
    return rng.normal(size=(b, d)).astype(np.float32)


def _excl(b, n_items, seed):
    rng = np.random.default_rng(seed)
    ex = rng.integers(0, n_items, (b, 6)).astype(np.int32)
    ex[:, 4:] = -1                                   # pads
    ex[0, :] = -1                                    # a row with none
    return ex


@pytest.mark.parametrize("bits,d", [(8, 16), (4, 16), (2, 13)])
def test_topk_ties_identical_to_jax(bits, d):
    n_items, b, k = 150, 6, 20
    tq, jq = _tables(n_items, d, bits, bits, integer=True)
    q = _queries(b, d, 1, integer=True)
    ex = _excl(b, n_items, 2)
    # block_i 64 puts ties across chunk boundaries and a ghost-padded tail
    # (the port's plain schedule takes the chunk size; its kernel's is fixed)
    jv, ji = jsc.topk_scores(jnp.asarray(q), jq, k, exclude=jnp.asarray(ex),
                             backend="jnp", block_i=64)
    tv, ti = ttk.topk_plain(torch.from_numpy(q), tq, torch.from_numpy(ex),
                            k=k, block_i=64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not (ti.numpy()[:, :, None] == ex[:, None, :]).any()


def _assert_topk_close(tv, ti, jv, ji, tol=1e-6):
    tv, ti, jv, ji = (np.asarray(a) for a in (tv, ti, jv, ji))
    np.testing.assert_allclose(tv, jv, rtol=0, atol=tol)
    diff = ti != ji
    # an index may differ only where its score is within tol of the other's
    assert (np.abs(tv - jv)[diff] <= tol).all()


def test_topk_random_packed_close_to_jax():
    n_items, d, b, k = 300, 32, 8, 10
    tq, jq = _tables(n_items, d, 4, 5, integer=False)
    q = _queries(b, d, 6, integer=False)
    ex = _excl(b, n_items, 7)
    jv, ji = jsc.topk_scores(jnp.asarray(q), jq, k, exclude=jnp.asarray(ex),
                             backend="jnp", block_i=128)
    tv, ti = tsc.topk_scores(torch.from_numpy(q), tq, k,
                             exclude=torch.from_numpy(ex))
    _assert_topk_close(tv, ti, jv, ji)


def test_topk_dense_fp32_close_to_jax():
    rng = np.random.default_rng(8)
    items = rng.normal(size=(90, 12)).astype(np.float32)
    q = _queries(5, 12, 9, integer=False)
    ex = _excl(5, 90, 10)
    jv, ji = jsc.topk_scores(jnp.asarray(q), jnp.asarray(items), 7,
                             exclude=jnp.asarray(ex), block_i=32)
    tv, ti = tsc.topk_scores(torch.from_numpy(q), torch.from_numpy(items), 7,
                             exclude=torch.from_numpy(ex))
    _assert_topk_close(tv, ti, jv, ji)


def test_topk_matches_interpret_kernel():
    """One tiny case through the Pallas top-K kernel (interpret mode)."""
    n_items, d, b, k = 70, 16, 4, 5
    tq, jq = _tables(n_items, d, 8, 11, integer=True)
    q = _queries(b, d, 12, integer=True)
    ex = _excl(b, n_items, 13)
    jv, ji = jtk.fused_topk_scores(
        jnp.asarray(q), jq.packed, jq.scale, jq.zero, jnp.asarray(ex),
        bits=8, dim=d, k=k, n_items=n_items, block_i=32, interpret=True)
    tv, ti = tsc.topk_scores(torch.from_numpy(q), tq, k,
                             exclude=torch.from_numpy(ex))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(14)
    parts_v = [rng.integers(0, 3, (4, 5)).astype(np.float32) for _ in range(3)]
    parts_i = [np.sort(rng.choice(40, (4, 5), replace=True), axis=1)
               + 40 * s for s in range(3)]
    jv, ji = jsc.merge_topk(parts_v, parts_i, 6)
    tv, ti = tsc.merge_topk(parts_v, parts_i, 6)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)


def test_topk_rejects_k_past_items():
    tq, _ = _tables(10, 8, 8, 0, integer=True)
    with pytest.raises(ValueError, match="n_items"):
        tsc.topk_scores(torch.zeros((1, 8)), tq, 11)


# -- the plain version at the card tests' ragged grid --------------------------


def _ragged_excl(b, n_items, seed):
    """Exclusions with duplicates, pads, a row with none and (B > 1) a row
    that removes items 128-255 whole: 130 columns."""
    rng = np.random.default_rng(seed)
    ex = np.full((b, 130), -1, np.int32)
    ex[:, :12] = rng.integers(0, n_items, (b, 12))
    ex[0, :12] = [5, 5, 5, 90, 90, 0, 0, 100, 100, 17, 17, 5]
    if b > 1:
        ex[1, :128] = np.arange(128, 256)
    if b > 2:
        ex[2, :] = -1
    return ex


@pytest.mark.parametrize("b", [1, 3, 8, 33])
@pytest.mark.parametrize("k", [1, 20, 129, 300])
def test_topk_plain_ragged_ties_identical_to_jax(b, k):
    """The plain top-K (what the kernel is held to on the card) at ragged
    B and k across 1..n_items, on integer-valued ties with duplicate
    exclusions and a whole excluded item tile: identical to the JAX
    package."""
    n_items, d = 300, 8
    tq, jq = _tables(n_items, d, 8, b + k, integer=True)
    q = _queries(b, d, b * k, integer=True)
    ex = _ragged_excl(b, n_items, k)
    jv, ji = jsc.topk_scores(jnp.asarray(q), jq, k, exclude=jnp.asarray(ex),
                             backend="jnp", block_i=128)
    tv, ti = ttk.topk_plain(torch.from_numpy(q), tq, torch.from_numpy(ex),
                            k=k, block_i=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    live = n_items - max(len(set(r[r >= 0])) for r in ex)
    if k <= live:
        assert not (ti.numpy()[:, :, None] == ex[:, None, :]).any()
