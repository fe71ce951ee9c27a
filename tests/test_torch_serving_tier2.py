"""Port parity: serving tier 2 (delta refresh, hot-user cache, metrics
registry, tracer, the tier-2 engine, two-stage streaming eval, launcher).

The delta between two stores must list the same rows as the JAX package's
and round-trip bit for bit; the cache and the metrics registry must behave
as the reference's under the same operations; the engine's shards,
two-stage path, cache and refresh must give what direct scoring gives.
"""

from __future__ import annotations

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics
from repro.serving import cache as jcache
from repro.serving import eval as jeval
from repro.serving import refresh as jrefresh
from repro.serving import store as jstore
from repro_torch.launch import serve as tserve
from repro_torch.obs import Tracer
from repro_torch.obs import metrics as tmetrics
from repro_torch.serving import cache as tcache
from repro_torch.serving import eval as teval
from repro_torch.serving import refresh as trefresh
from repro_torch.serving import store as tstore
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scorer import topk_scores, two_stage_topk

U, I, D, K = 16, 257, 32, 10


def _reps(seed, n_users=U, n_items=I, d=D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_users, d)).astype(np.float32),
            rng.normal(size=(n_items, d)).astype(np.float32))


def _perturbed(a, rows):
    out = a.copy()
    out[rows] += 1.0
    return out


def _store(users, items, bits=8, quantize_users=False):
    return tstore.QuantizedEmbeddingStore.from_arrays(
        torch.from_numpy(users), torch.from_numpy(items), bits=bits,
        quantize_users=quantize_users)


def _leaves(t):
    if isinstance(t, torch.Tensor):
        return [t.numpy()]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (t.packed, t.scale, t.zero)]


@pytest.mark.parametrize("bits", [8, None])
def test_store_delta_round_trip_and_matches_jax(bits):
    users, items = _reps(0)
    new_u, new_i = _perturbed(users, [3]), _perturbed(items, [7, 100])
    old, new = (_store(u, i, bits, True) for u, i in
                ((users, items), (new_u, new_i)))
    d = trefresh.store_delta(old, new)
    patched = trefresh.apply_delta(old, d)
    for side in ("users", "items"):
        for a, b in zip(_leaves(getattr(patched, side)),
                        _leaves(getattr(new, side))):
            np.testing.assert_array_equal(a, b)
    # the old store is left as it was
    for a, b in zip(_leaves(old.items), _leaves(_store(users, items, bits,
                                                       True).items)):
        np.testing.assert_array_equal(a, b)
    jd = jrefresh.store_delta(*(jstore.QuantizedEmbeddingStore.from_arrays(
        jnp.asarray(u), jnp.asarray(i), bits=bits)
        for u, i in ((users, items), (new_u, new_i))))
    np.testing.assert_array_equal(d.user_ids, jd.user_ids)
    np.testing.assert_array_equal(d.item_ids, jd.item_ids)
    for rows, jrows in ((d.user_rows, jd.user_rows),
                        (d.item_rows, jd.item_rows)):
        for a, b in zip(rows, jrows):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert d.stats() == jd.stats()


def test_store_delta_named_mismatch_errors():
    users, items = _reps(1)
    st8, st4 = _store(users, items, 8), _store(users, items, 4)
    with pytest.raises(ValueError, match="bits"):
        trefresh.store_delta(st8, st4)
    small = _store(users[:4], items, 8)
    with pytest.raises(ValueError, match="shapes"):
        trefresh.store_delta(st8, small)
    d = trefresh.store_delta(st8, st8)
    assert d.n_changed == 0
    with pytest.raises(ValueError, match="delta targets"):
        trefresh.apply_delta(small, d)


def test_result_cache_behaves_as_jax():
    """The same put/get/drop/clear sequence on both caches: equal hits,
    contents, evictions and metric snapshots."""
    regs = (jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry())
    caches = (jcache.ResultCache(3, registry=regs[0], label="c"),
              tcache.ResultCache(3, registry=regs[1], label="c"))
    rng = np.random.default_rng(2)
    for step in range(60):
        op, uid = rng.integers(0, 10), int(rng.integers(0, 6))
        outs = []
        for c in caches:
            if op < 5:
                ent = c.get(uid)
                outs.append(None if ent is None else
                            (ent[0], ent[1].tolist(), ent[2].tolist()))
            elif op < 8:
                c.put(uid, step, np.full(2, step, np.float32),
                      np.arange(2) + uid)
                outs.append(list(c._od))
            elif op < 9:
                outs.append(c.drop([uid, (uid + 1) % 6]))
            else:
                outs.append(c.clear())
        assert outs[0] == outs[1], step
    assert caches[0].hit_rate == caches[1].hit_rate > 0
    assert regs[0].snapshot() == regs[1].snapshot()
    with pytest.raises(ValueError, match="capacity"):
        tcache.ResultCache(0)


def test_metrics_snapshot_matches_jax_past_capacity():
    rng = np.random.default_rng(3)
    xs = rng.exponential(5.0, 700)
    snaps = []
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        h = reg.histogram("serve/latency_ms", capacity=64, engine="e0")
        c = reg.counter("serve/requests", engine="e0")
        for x in xs:
            h.observe(x)
            c.inc()
        reg.gauge("serve/store_version", engine="e0").set(2)
        before = reg.snapshot()
        h.observe(1.0)
        snaps.append((before, reg.snapshot(),
                      mod.diff(before, reg.snapshot())))
    assert snaps[0] == snaps[1]
    assert snaps[1][0]["histograms"]["serve/latency_ms{engine=e0}"][
        "count"] == 700


def test_tracer_spans_and_chrome_trace(tmp_path):
    tr = Tracer()
    with tr.span("off"):
        pass
    assert tr.events() == []
    tr.enable()
    with tr.span("serve/batch", n=3):
        with tr.step_span("train/step", 7):
            pass
    t = threading.Thread(target=lambda: tr.span("other").__enter__()
                         .__exit__(None, None, None))
    t.start()
    t.join()
    ev = {e["name"]: e for e in tr.events()}
    assert set(ev) == {"serve/batch", "train/step", "other"}
    assert ev["serve/batch"]["args"] == {"n": 3}
    assert ev["train/step"]["args"] == {"step": 7}
    assert ev["other"]["tid"] != ev["serve/batch"]["tid"]
    out = json.loads(open(tr.save(str(tmp_path / "t.json"),
                                  run={"kind": "serve"})).read())
    assert len(out["traceEvents"]) == 3
    assert out["metadata"]["kind"] == "serve"


def _burst(eng, users):
    futs = [eng.submit(int(u)) for u in users]
    return [f.result(timeout=60) for f in futs]


def test_engine_shards_bit_identical_on_ties():
    """1, 2 and 4 shards serve identical bits on tied integer scores, for
    the single-stage and the two-stage path."""
    rng = np.random.default_rng(33)
    users = rng.integers(-2, 3, (12, 8)).astype(np.float32)
    items = rng.integers(0, 4, (96, 8)).astype(np.float32)
    items[:, 0], items[:, 1] = 0.0, 3.0        # exact INT8 rows
    for two_stage in (None, 3):
        st = _store(users, items, 8)
        results = {}
        for shards in (1, 2, 4):
            with ServingEngine(st, k=12, buckets=(4,), item_shards=shards,
                               two_stage_c=two_stage) as eng:
                results[shards] = _burst(eng, range(12))
        for shards in (2, 4):
            for (v1, i1), (vs, is_) in zip(results[1], results[shards]):
                np.testing.assert_array_equal(i1, is_)
                np.testing.assert_array_equal(v1, vs)


def test_engine_two_stage_burst_equals_direct_scoring():
    """The engine's two-stage responses are the direct scorer's."""
    users, items = _reps(4)
    st = _store(users, items, 8)
    excl = tstore.padded_pos_lists(
        np.stack([np.arange(U).repeat(3),
                  np.random.default_rng(5).integers(0, I, 3 * U)], 1), U)
    ids = np.random.default_rng(6).integers(0, U, 13)
    with ServingEngine(st, k=K, exclude=excl, buckets=(1, 2, 4),
                       two_stage_c=4) as eng:
        eng.warmup()
        res = _burst(eng, ids)
    t = torch.from_numpy(ids)
    v, i = two_stage_topk(st.user_vectors(t), st.items, K, c=4,
                          exclude=torch.from_numpy(excl)[t])
    # the coarse stage is exact; the re-rank's batched product sums in an
    # order that may depend on the batch size (the engine's are 1, 2, 4)
    np.testing.assert_array_equal(np.stack([r[1] for r in res]), i.numpy())
    np.testing.assert_allclose(np.stack([r[0] for r in res]), v.numpy(),
                               rtol=1e-6, atol=0)


def test_engine_two_stage_needs_packed_store():
    users, items = _reps(7)
    with pytest.raises(ValueError, match="packed"):
        ServingEngine(_store(users, items, None), k=K, two_stage_c=4)


def test_engine_cache_replays_stamped_results(monkeypatch):
    """A hit replays the miss's result bit for bit, its stamp is the live
    version, and hits take no batch slot."""
    users, items = _reps(8)
    reg = tmetrics.MetricsRegistry()
    replays = []
    orig = ServingEngine._replay

    def audited(self, msg, ent):
        replays.append((msg[1], ent[0], self.version))
        orig(self, msg, ent)

    monkeypatch.setattr(ServingEngine, "_replay", audited)
    with ServingEngine(_store(users, items), k=K, buckets=(1, 4, 8),
                       cache_size=16, two_stage_c=4, item_shards=2,
                       registry=reg) as eng:
        first = [eng.submit(u).result(timeout=60) for u in range(8)]
        batches = eng.stats().n_batches
        again = [eng.submit(u).result(timeout=60) for u in range(8)]
        assert eng.stats().n_batches == batches
    for (v1, i1), (v2, i2) in zip(first, again):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(v1, v2)
    assert [r[0] for r in replays] == list(range(8))
    assert all(stamp == live == 0 for _, stamp, live in replays)
    assert reg.counter("serve/cache_hits", engine=eng.label).value == 8
    assert eng.stats().cache_hit_rate == pytest.approx(0.5)


def test_engine_refresh_atomic_and_invalidates_cache(monkeypatch):
    """Requests before a refresh are scored on the old store, after it on
    the new; a user-only delta drops exactly those users from the cache
    and the rest are restamped with the new version, an item delta clears
    it."""
    replays = []
    orig = ServingEngine._replay

    def audited(self, msg, ent):
        replays.append((msg[1], ent[0], self.version))
        orig(self, msg, ent)

    monkeypatch.setattr(ServingEngine, "_replay", audited)
    users, items = _reps(9)
    base = _store(users, items)
    user_only = _store(_perturbed(users, [0]), items)
    item_too = _store(_perturbed(users, [0]), _perturbed(items, [5]))
    reg = tmetrics.MetricsRegistry()

    def ref(st, u):
        t = torch.arange(U)
        return two_stage_topk(st.user_vectors(t), st.items, K,
                              c=4)[1].numpy()[u]

    with ServingEngine(base, k=K, buckets=(1, 4), cache_size=16,
                       two_stage_c=4, registry=reg) as eng:
        pre = [eng.submit(u) for u in (0, 1, 2)]
        fut = eng.refresh(user_only)
        post = [eng.submit(u) for u in (0, 1, 2)]
        stats = fut.result(timeout=60)
        r0 = {u: f.result(timeout=60) for u, f in zip((0, 1, 2), pre)}
        r1 = {u: f.result(timeout=60) for u, f in zip((0, 1, 2), post)}
        assert stats["version"] == 1 and stats["users_changed"] == 1
        assert stats["items_changed"] == 0
        for u in (0, 1, 2):
            np.testing.assert_array_equal(r0[u][1], ref(base, u))
            np.testing.assert_array_equal(r1[u][1], ref(user_only, u))
        for u in (1, 2):                   # served from the cache
            np.testing.assert_array_equal(r0[u][0], r1[u][0])
        hits = reg.counter("serve/cache_hits", engine=eng.label).value
        assert hits == 2 and replays == [(1, 1, 1), (2, 1, 1)]
        eng.refresh(item_too).result(timeout=60)
        r2 = {u: eng.submit(u).result(timeout=60) for u in (0, 1, 2)}
        for u in (0, 1, 2):               # rescored: the cache was cleared
            np.testing.assert_array_equal(r2[u][1], ref(item_too, u))
        assert reg.counter("serve/cache_hits",
                           engine=eng.label).value == hits
        bad = eng.refresh(_store(users, items, 4)).exception(timeout=60)
        assert isinstance(bad, ValueError) and "bits" in str(bad)
    assert eng.version == 2
    snap = reg.snapshot()
    assert snap["gauges"][f"serve/store_version{{engine={eng.label}}}"] == 2
    assert snap["counters"][
        f"serve/refresh_rows{{engine={eng.label}}}"] == 2


def test_engine_latency_percentiles_from_reservoir():
    users, items = _reps(10)
    reg = tmetrics.MetricsRegistry()
    with ServingEngine(_store(users, items), k=K, buckets=(1, 4),
                       two_stage_c=4, lat_capacity=8, registry=reg) as eng:
        _burst(eng, np.arange(20) % U)
        stats = eng.stats()
    snap = reg.snapshot()["histograms"]
    lat = snap[f"serve/latency_ms{{engine={eng.label}}}"]
    assert lat["count"] == stats.n_requests == 20
    assert (stats.p50_ms, stats.p99_ms) == (lat["p50"], lat["p99"])
    for stage in ("coarse", "rerank"):
        h = snap[f"serve/stage_ms{{engine={eng.label},stage={stage}}}"]
        assert h["count"] == stats.n_batches > 0
    assert reg.snapshot()["gauges"][
        f"serve/candidate_frac{{engine={eng.label}}}"] == 4 * K / I


def test_streaming_eval_two_stage_matches_jax():
    users, items = _reps(11, 32, 60, 16)     # two chunks of one shape
    rng = np.random.default_rng(12)
    train = np.unique(np.stack([np.arange(32).repeat(4),
                                rng.integers(0, 60, 128)], 1), axis=0)
    test = np.unique(np.stack([np.arange(28).repeat(2),
                               rng.integers(0, 60, 56)], 1), axis=0)
    js = jstore.QuantizedEmbeddingStore.from_arrays(
        jnp.asarray(users), jnp.asarray(items), bits=8)
    ts = tstore.QuantizedEmbeddingStore.from_arrays(
        torch.from_numpy(users), torch.from_numpy(items), bits=8)
    for c in (2, 6):                      # 6 * 10 >= 60: the anchor
        ref = jeval.streaming_recall_ndcg(js, train, test, k=10,
                                          user_chunk=16, backend="jnp",
                                          two_stage_c=c)
        got = teval.streaming_recall_ndcg(ts, train, test, k=10,
                                          user_chunk=16, two_stage_c=c)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    single = teval.streaming_recall_ndcg(ts, train, test, k=10)
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-9)


def test_launcher_tier2_flags_on_cpu(capsys):
    tserve.main(["--arch", "kgat", "--bits", "8", "--two-stage", "4",
                 "--item-shards", "2", "--cache", "16", "--train-steps", "2",
                 "--refresh-steps", "2", "--requests", "12", "--device",
                 "cpu"])
    out = capsys.readouterr().out
    assert "rollout after 2 BPR steps" in out
    assert "12 req" in out and "refresh v1" in out
    assert "post-refresh: 24 req" in out
    assert "dense reference" in out
