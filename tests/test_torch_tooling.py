"""The port's tooling layer against the reference's, on the CPU: the
roofline (``launch/roofline.py``), the dry run and its report
(``launch/dryrun.py``, ``launch/report.py``), the autotuner
(``kernels/autotune.py``), ``embedding_bag``, both samplers on an edgeless
graph, and a tiny run of the ``train_kgnn`` example. Reduced sizes, no
subprocess."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jtune
from repro.launch import report as jreport
from repro.launch import roofline as jroof
from repro.models.layers import embedding_bag as jbag
from repro_torch.core.quant import quantize
from repro_torch.data import sampler as tsampler
from repro_torch.data.csr import build_spmm_layout
from repro_torch.data.minibatch import build_kg_csr, sample_kg_blocks
from repro_torch.kernels import autotune as ttune
from repro_torch.kernels import dequant_matmul as tdqmm
from repro_torch.kernels import ops
from repro_torch.kernels import quant_pack as tqp
from repro_torch.kernels import spmm as tspmm
from repro_torch.kernels import topk_score as ttk
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as troof
from repro_torch.models.layers import embedding_bag as tbag
from repro_torch.models.registry import GNN_DP_UNSUPPORTED

# -- roofline -----------------------------------------------------------------

_HLO = """ENTRY %main (p: f32[1024]) -> f32[1024] {
  %p = f32[1024]{0} parameter(0)
  %ar = f32[1024]{0} all-reduce(%p), replica_groups=[2,4]<=[8], to_apply=%s
  %ag = f32[4096]{0} all-gather(%p), replica_groups=[2,4]<=[8], dimensions={0}
  %rs = f32[256]{0} reduce-scatter(%p), replica_groups={{0,1}}, to_apply=%s
  %aa = f32[1024]{0} all-to-all(%p), replica_groups=[1,8]<=[8]
  ROOT %cp = f32[1024]{0} collective-permute(%p), source_target_pairs={{0,1}}
}
"""


def test_collective_model_and_terms_match_reference():
    """The per-kind collective model gives the reference's bytes on the
    same collectives (the reference's read from HLO, the port's from the
    result bytes and group sizes), and ``roofline_terms`` the reference's
    terms on the same stats and profile."""
    ref = jroof.parse_hlo(_HLO, n_devices=8)
    mine = troof.StepStats()
    for kind, nbytes, g in (("all-reduce", 4096, 4), ("all-gather", 16384, 4),
                            ("reduce-scatter", 1024, 2),
                            ("all-to-all", 4096, 8),
                            ("collective-permute", 4096, 8)):
        moved = troof.collective_moved(kind, nbytes, g)
        mine.per_kind[kind] = moved
        mine.collective_bytes += moved
        mine.n_collectives += 1
    assert mine.per_kind == ref.per_kind
    assert (mine.collective_bytes, mine.n_collectives) == \
        (ref.collective_bytes, ref.n_collectives)
    mine.flops, mine.hbm_bytes = 3.0e12, 7.5e9
    ref.flops, ref.hbm_bytes = mine.flops, mine.hbm_bytes
    for hw in ("h100", "host"):
        prof = troof.get_hw(hw)
        assert troof.roofline_terms(mine, model_flops_per_device=1e12,
                                    hw=prof) == \
            jroof.roofline_terms(ref, model_flops_per_device=1e12, hw=prof)
    with pytest.raises(KeyError, match="choose from"):
        troof.get_hw("tpu-v5e")


def test_trace_step_counts_matmuls_and_kernel_costs():
    """A matmul chain counts exactly 2·M·N·K a product; a kernel's call on
    its plain path counts its cost function, and none of the plain
    version's aten ops (its own matmul)."""
    gen = torch.Generator().manual_seed(0)
    x, w1, w2 = (torch.randn(s, generator=gen)
                 for s in ((8, 16), (16, 32), (32, 4)))
    t = troof.trace_step(lambda: (x @ w1) @ w2, hw="host")
    assert t.stats.flops == t.aten_flops == 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4
    assert t.kernels == {} and t.terms["hlo_flops"] == t.stats.flops

    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 9, 40), rng.integers(0, 7, 40)
    layout = build_spmm_layout(src, dst, n_dst=7, n_src=9, device="cpu")
    xs, ew = torch.randn((9, 5), generator=gen), torch.rand(40)
    q = quantize(torch.randn((9, 5), generator=gen), 3, bits=2)
    g = torch.randn((9, 4), generator=gen)
    items = quantize(torch.randn((30, 5), generator=gen), 4, bits=8)
    excl = torch.full((2, 1), -1, dtype=torch.int32)
    cases = (
        ("spmm", lambda: ops.spmm(xs, ew, layout),
         tspmm.spmm_cost(layout, 5)),
        ("dequant_matmul", lambda: ops.dequant_matmul(q, g),
         tdqmm.dequant_matmul_cost(9, 5, 4, q.packed.shape[1])),
        ("topk_score", lambda: ops.topk(xs[:2], items, excl, k=3),
         ttk.topk_cost(2, 30, 5, 3, dp=items.packed.shape[1], n_excl=2)),
        ("quant_pack", lambda: ops.quant_pack(xs, 1, bits=2),
         tqp.quant_pack_cost(9, 5, bits=2)))
    for name, run, c in cases:
        t = troof.trace_step(run)
        assert t.kernels == {name: [1, c.flops, c.bytes]}, name
        assert t.aten_flops == 0 and t.aten_bytes == 0, name
        assert t.stats.flops == c.flops and t.stats.hbm_bytes == c.bytes


def test_kernel_bound_ms():
    c = tqp.quant_pack_cost(184166, 64, bits=2)
    hw = troof.get_hw("h100")
    ms, by = troof.kernel_bound_ms(c, hw)
    assert by == "bytes" and ms == pytest.approx(
        (184166 * 64 * 4 + 184166 * 24) / 3.35e12 * 1e3, rel=1e-12)
    c = tdqmm.dequant_matmul_cost(184166, 64, 64, 16)
    assert troof.kernel_bound_ms(c, hw)[0] >= c.flops / 989e12 * 1e3


# -- report and dry run -------------------------------------------------------


def _records():
    def rec(arch, shape, peak, dominant, frac):
        return {"arch": arch, "shape": shape, "mesh": "1", "ok": True,
                "compile_s": 1.25, "first_step_s": 1.25,
                "memory": {"peak_gb": peak, "argument_gb": peak / 3},
                "roofline": {"compute_s": 0.0123, "memory_s": 1.5,
                             "collective_s": 0.0, "dominant": dominant,
                             "roofline_fraction": frac}}
    recs = {("kgat", "paper_full", "1"): rec("kgat", "paper_full", 23.4,
                                             "memory_s", 0.008),
            ("xdeepfm", "train_batch", "1"): rec("xdeepfm", "train_batch",
                                                 12.0, "compute_s", None)}
    recs[("fm", "train_batch", "1")] = {
        "arch": "fm", "shape": "train_batch", "mesh": "1", "ok": False,
        "error": "ValueError: " + "x" * 80}
    return recs


def test_report_tables_match_reference():
    recs = _records()
    assert treport.dryrun_table(recs) == jreport.dryrun_table(recs)
    assert treport.roofline_table(recs, "1") == \
        jreport.roofline_table(recs, "1")
    summary = {"run": {"kind": "train", "arch": "kgat", "mesh": None},
               "counters": {"train/steps": 4},
               "gauges": {"train/loss": 0.6931},
               "histograms": {"train/step_ms": {
                   "count": 4, "sum": 10.0, "min": 2.0, "max": 3.0,
                   "p50": 2.5, "p95": 2.9, "p99": 2.99}}}
    assert treport.metrics_table(summary) == jreport.metrics_table(summary)
    assert treport.fmt_s(None) == jreport.fmt_s(None) == "-"


def test_dry_run_cell_on_cpu_renders(tmp_path, capsys):
    """A reduced cell on the CPU writes an ok record that the report
    renders; a refused cell writes its refusal."""
    rec = tdry.run_cell("kgat", device="cpu", hw="host",
                        out_dir=str(tmp_path))
    assert rec["ok"], rec.get("traceback")
    assert rec["memory"]["peak_gb"] is None and rec["memory"]["act_gb"] > 0
    assert rec["roofline"]["hlo_flops"] > 0 and rec["kernels"]["spmm"][0] > 0
    bad = tdry.run_cell("gcn-cora", device="cpu", mesh="data=2",
                        out_dir=str(tmp_path))
    assert not bad["ok"] and GNN_DP_UNSUPPORTED in bad["error"]
    assert not tdry.run_cell("stablelm-12b", "decode_32k", device="cpu",
                             out_dir=None, verbose=False)["ok"]
    recs = treport.load_dir(str(tmp_path))
    assert sorted(recs) == [("gcn-cora", "full_graph_sm", "data=2"),
                            ("kgat", "paper_full", "1")]
    out = tmp_path / "report.md"
    treport.main(["--dryrun", str(tmp_path), "--out", str(out)])
    text = out.read_text()
    assert "| kgat | paper_full | 1 |" in text and "FAIL" in text
    assert json.loads((tmp_path / "kgat__paper_full__1__b2.json")
                      .read_text())["ok"]


# -- autotune -----------------------------------------------------------------


def test_autotune_keys_match_reference():
    for n in (0, 1, 2, 3, 8, 9, 24915, 1_000_000):
        assert ttune.shape_bucket(n) == jtune.shape_bucket(n)
    for args, kw in ((("topk_score", (8, 24915, 64)),
                      dict(bits=8, extra="k20")),
                     (("coarse_topm", (128, 1000000, 33)), dict(bits=2)),
                     (("op", (5,)), {})):
        assert ttune.Autotuner.key(*args, **kw) == \
            jtune.Autotuner.key(*args, **kw)


def test_autotune_cache_round_trip(tmp_path, monkeypatch):
    """A sweep stores the fastest candidate under the fingerprint; a
    second tuner on the file returns it with no measurement; another
    fingerprint sees nothing of it."""
    times = {8: 3.0, 16: 1.0, 32: 2.0}
    monkeypatch.setattr(ttune, "_device_ms",
                        lambda fn, reps: (fn(), times[ran[-1]])[1])
    ran = []
    path = str(tmp_path / "cache.json")
    cands = [{"qt": t} for t in ttune.QUERY_TILES]
    pick = dict(shapes=(8, 24915, 64), bits=8, extra="k20",
                candidates=cands, measure=lambda p: ran.append(p["qt"]),
                default={"qt": 0})
    a = ttune.Autotuner(path, sweep=True, fingerprint="card-a")
    assert a.pick("topk_score", **pick) == {"qt": 16}
    assert a.n_sweeps == 3 and set(ran) == {8, 16, 32}
    data = json.loads(open(path).read())
    key = a.key("topk_score", (8, 24915, 64), bits=8, extra="k20")
    assert data["version"] == 1 and data["card-a"][key]["winner"] == \
        {"qt": 16}
    ran.clear()
    b = ttune.Autotuner(path, sweep=True, fingerprint="card-a")
    assert b.pick("topk_score", **pick) == {"qt": 16}
    assert b.n_sweeps == 0 and ran == []
    c = ttune.Autotuner(path, sweep=False, fingerprint="card-b")
    assert c.lookup(key) is None and c.pick("topk_score", **pick) == \
        {"qt": 0}
    assert ttune.reset(path, sweep=False, fingerprint="card-b") is \
        ttune.get()
    assert ttune.reset() is None


# -- embedding_bag ------------------------------------------------------------


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(combiner, weighted):
    """Forward and the table's gradient within 1e-6 of ``jax.grad`` of the
    reference's; an empty bag included."""
    rng = np.random.default_rng(int(weighted) + 2 * (combiner == "mean"))
    table = rng.standard_normal((11, 4)).astype(np.float32)
    idx = rng.integers(0, 11, 23)
    seg = np.sort(rng.integers(0, 6, 23))
    seg[seg == 3] = 4                           # bag 3 is empty
    w = rng.random(23).astype(np.float32) if weighted else None
    cot = rng.standard_normal((6, 4)).astype(np.float32)

    def jloss(t):
        out = jbag(t, jnp.asarray(idx), jnp.asarray(seg), 6,
                   weights=None if w is None else jnp.asarray(w),
                   combiner=combiner)
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(table))
    tt = torch.tensor(table, requires_grad=True)
    out = tbag(tt, idx, seg, 6, combiner=combiner,
               weights=None if w is None else torch.tensor(w))
    (out * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="unknown combiner max"):
        tbag(tt, idx, seg, 6, combiner="max")


# -- samplers on an edgeless graph --------------------------------------------


def test_kg_sampler_on_edgeless_graph():
    """Every slot a masked weight-0 self edge; the draws the reference's
    (one ``rng.integers`` a hop), so the stream goes on unchanged."""
    none = np.zeros(0, np.int64)
    adj = build_kg_csr(none, none, none, 33, 3)
    seeds = np.array([0, 5, 7, 32])
    rng, twin = np.random.default_rng(1), np.random.default_rng(1)
    view, inp, req = sample_kg_blocks(adj, seeds, (1, 2), rng=rng)
    n = len(seeds)
    for fanout in (1, 2):
        twin.integers(0, np.ones((n, 1), np.int64), (n, fanout))
        n *= fanout + 1
    assert rng.integers(1 << 30) == twin.integers(1 << 30)
    np.testing.assert_array_equal(req, seeds)
    for blk in view.blocks:
        assert float(blk.mask.sum()) == 0
        np.testing.assert_array_equal(inp[blk.src.numpy()],
                                      inp[blk.dst.numpy()])


def test_gcn_sampler_on_edgeless_graph():
    """Every slot its frontier node's self loop; the draws the
    reference's."""
    none = np.zeros(0, np.int64)
    indptr, indices = tsampler.build_csr(none, none, 5)
    rng, twin = np.random.default_rng(2), np.random.default_rng(2)
    blocks, inp = tsampler.sample_blocks(indptr, indices, np.array([1, 3]),
                                         [2, 1], rng=rng)
    for n, fanout in ((2, 2), (6, 1)):
        twin.integers(0, np.ones((n, 1), np.int64), (n, fanout))
    assert rng.integers(1 << 30) == twin.integers(1 << 30)
    for b in blocks:
        np.testing.assert_array_equal(b["src_nodes"][b["src"]],
                                      b["dst_nodes"][b["dst"]])


# -- the examples -------------------------------------------------------------


def test_train_kgnn_example_on_cpu(tmp_path, capsys):
    from repro_torch.examples import train_kgnn

    res = train_kgnn.main(["--device", "cpu", "--steps", "3", "--dim", "8",
                           "--scale", "0.002", "--ckpt", str(tmp_path)])
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert 0 <= res["recall@20"] <= 1
    assert "final: recall@20=" in capsys.readouterr().out

