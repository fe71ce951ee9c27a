"""Port parity: packed store, engine, streaming eval and launcher.

The store packed from the same fp32 tables must be bit-identical to the JAX
``QuantizedEmbeddingStore.from_arrays`` at 8 and 4 bits; the streaming eval
within 1e-6 of the JAX evaluator's; engine responses equal direct
``topk_scores`` calls.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import eval as jeval
from repro.serving import store as jstore
from repro_torch.launch import serve as tserve
from repro_torch.serving import eval as teval
from repro_torch.serving import store as tstore
from repro_torch.serving.engine import BackpressureError, ServingEngine
from repro_torch.serving.scorer import topk_scores


def _reps(n_users, n_items, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_users, d)).astype(np.float32),
            rng.normal(size=(n_items, d)).astype(np.float32))


@pytest.mark.parametrize("bits", [8, 4])
def test_store_bit_identical_to_jax(bits):
    users, items = _reps(21, 33, 24, bits)
    ref = jstore.QuantizedEmbeddingStore.from_arrays(
        jnp.asarray(users), jnp.asarray(items), bits=bits)
    got = tstore.QuantizedEmbeddingStore.from_arrays(
        torch.from_numpy(users), torch.from_numpy(items), bits=bits)
    for side in ("users", "items"):
        r, g = getattr(ref, side), getattr(got, side)
        for f in ("packed", "scale", "zero"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(r, f)),
                                          err_msg=f"{side}.{f}")
        assert (g.bits, g.dim) == (r.bits, r.dim)
    assert got.memory_report() == ref.memory_report()


def test_padded_pos_lists_matches_jax():
    rng = np.random.default_rng(0)
    pos = np.stack([rng.integers(0, 9, 40), rng.integers(0, 50, 40)], 1)
    np.testing.assert_array_equal(tstore.padded_pos_lists(pos, 11),
                                  jstore.padded_pos_lists(pos, 11))


def _pos_pairs(n_users, n_items, per_user, seed):
    rng = np.random.default_rng(seed)
    pairs = np.stack([np.repeat(np.arange(n_users), per_user),
                      rng.integers(0, n_items, n_users * per_user)], 1)
    return np.unique(pairs, axis=0)


@pytest.mark.parametrize("bits", [None, 8])
def test_streaming_eval_matches_jax(bits):
    users, items = _reps(45, 60, 16, 1)
    train = _pos_pairs(45, 60, 4, 2)
    test = _pos_pairs(40, 60, 2, 3)                  # 5 users without tests
    ref_store = jstore.QuantizedEmbeddingStore.from_arrays(
        jnp.asarray(users), jnp.asarray(items), bits=bits)
    store = tstore.QuantizedEmbeddingStore.from_arrays(
        torch.from_numpy(users), torch.from_numpy(items), bits=bits)
    ref = jeval.streaming_recall_ndcg(ref_store, train, test, k=10,
                                      user_chunk=16, backend="jnp",
                                      block_i=32)
    got = teval.streaming_recall_ndcg(store, train, test, k=10,
                                      user_chunk=16)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_engine_responses_equal_direct_scoring():
    users, items = _reps(30, 50, 16, 4)
    store = tstore.QuantizedEmbeddingStore.from_arrays(
        torch.from_numpy(users), torch.from_numpy(items), bits=8)
    excl = tstore.padded_pos_lists(_pos_pairs(30, 50, 3, 5), 30)
    ids = np.random.default_rng(6).integers(0, 30, 23)
    with ServingEngine(store, k=7, exclude=excl, buckets=(1, 2, 4)) as eng:
        eng.warmup()
        futs = [eng.submit(int(u)) for u in ids]
        res = [f.result(timeout=30) for f in futs]
        stats = eng.stats()
    t = torch.from_numpy(ids)
    v, i = topk_scores(store.user_vectors(t), store.items, 7,
                       exclude=torch.from_numpy(excl)[t])
    np.testing.assert_array_equal(np.stack([r[1] for r in res]), i.numpy())
    np.testing.assert_array_equal(np.stack([r[0] for r in res]), v.numpy())
    assert stats.n_requests == len(ids) and stats.n_batches >= 6
    assert stats.p99_ms >= stats.p50_ms > 0


def test_engine_backpressure_and_shutdown():
    users, items = _reps(4, 10, 8, 7)
    store = tstore.QuantizedEmbeddingStore.from_arrays(
        torch.from_numpy(users), torch.from_numpy(items), bits=None)
    eng = ServingEngine(store, k=3, max_pending=2)
    with pytest.raises(RuntimeError, match="not started"):
        eng.submit(0)
    with eng:
        # fill the queue faster than one worker drains it
        with pytest.raises(BackpressureError):
            for _ in range(10_000):
                eng.submit(1)
    assert eng._thread is None


def test_launcher_runs_on_cpu(capsys):
    tserve.main(["--arch", "kgat", "--bits", "4", "--requests", "6",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] store: bits=4" in out
    assert "6 req" in out
    assert "dense reference" in out
