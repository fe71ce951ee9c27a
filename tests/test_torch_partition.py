"""Port parity for the multi-rank path's host-side pieces, in process (no
ranks are started): the edge and row partitions, each shard's layout, the
mesh spec grammar, the all-reduce byte report and the named errors, held
against the JAX package; the port's own sent-byte count and each rank's
device and backend.

Everything here is exact: arrays equal, strings equal, byte counts equal.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro.data import csr as jcsr
from repro.sharding.mesh_spec import MeshSpec as JMeshSpec
from repro.sharding.mesh_spec import MeshSpecError as JMeshSpecError
from repro.training import compress as jcompress
from repro.training import data_parallel as jdp
from repro_torch.data import csr as tcsr
from repro_torch.data.synthetic import gen_kg_dataset
from repro_torch.models import kgnn as tk
from repro_torch.models.registry import build_step
from repro_torch.sharding.mesh_spec import MeshSpec, MeshSpecError
from repro_torch.training import compress as tcompress
from repro_torch.training import data_parallel as tdp

FIELDS = ("src_g", "src_h", "dst_l", "rel", "mask", "perm", "halo",
          "halo_count")


@pytest.fixture(scope="module")
def ds():
    return gen_kg_dataset(n_users=16, n_items=32, n_attrs=16, seed=0)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_partition_arrays_match_jax(ds, n_shards):
    """``partition_edges``, ``unpartition_edges`` and ``row_partition``
    give the JAX package's arrays and geometry, on the small CKG and on a
    graph whose node count no shard count divides."""
    rng = np.random.default_rng(3)
    graphs = [(ds.src, ds.dst, ds.rel, ds.n_nodes),
              (rng.integers(0, 37, 211), rng.integers(0, 37, 211),
               rng.integers(0, 7, 211), 37)]
    for src, dst, rel, n in graphs:
        tp = tcsr.partition_edges(src, dst, rel, n_nodes=n,
                                  n_shards=n_shards)
        jp = jcsr.partition_edges(src, dst, rel, n_nodes=n,
                                  n_shards=n_shards)
        for f in FIELDS:
            a, b = getattr(tp, f), np.asarray(getattr(jp, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (tp.n_shards, tp.rows_per_shard, tp.n_nodes, tp.n_edges,
                tp.n_nodes_padded, tp.e_cap, tp.h_cap) == \
            (jp.n_shards, jp.rows_per_shard, jp.n_nodes, jp.n_edges,
             jp.n_nodes_padded, jp.e_cap, jp.h_cap)
        for a, b in zip(tcsr.unpartition_edges(tp),
                        jcsr.unpartition_edges(jp)):
            assert np.array_equal(a, b)
        for m in (1, 2, 3):
            trp = tcsr.row_partition(n, m, pad_to=tp.n_nodes_padded)
            jrp = jcsr.row_partition(n, m, pad_to=jp.n_nodes_padded)
            assert (trp.n_rows, trp.n_shards, trp.rows_per_shard,
                    trp.n_rows_padded) == (jrp.n_rows, jrp.n_shards,
                                           jrp.rows_per_shard,
                                           jrp.n_rows_padded)
            table = rng.normal(size=(n, 3)).astype(np.float32)
            assert np.array_equal(trp.blocks(table), jrp.blocks(table))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_layout_reproduces_real_edges(ds, n_shards):
    """Each shard's layout holds exactly the shard's real edges: in the
    forward direction every real edge's slot gathers its halo row into its
    destination row and the pads spread over rows with weight-0 masks; an
    SPMM over the shard with its real edges' weights equals the
    single-device SPMM's rows of the shard (halo rows gathered from the
    full table); the relation grouping covers every edge."""
    part = tcsr.partition_edges(ds.src, ds.dst, ds.rel, n_nodes=ds.n_nodes,
                                n_shards=n_shards)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(ds.n_nodes, 5)).astype(np.float32))
    ew = torch.from_numpy(rng.random(len(ds.src)).astype(np.float32))
    full = torch.zeros((ds.n_nodes, 5)).index_add_(
        0, torch.from_numpy(ds.dst).long(),
        x[torch.from_numpy(ds.src).long()] * ew[:, None])
    for s in range(n_shards):
        a = tcsr.shard_graph_arrays(part, s, ds.n_relations, device="cpu")
        k = a["n_real"]
        lay = a["layout"]
        assert k == int(part.mask[s].sum())
        assert lay.meta.n_edges == part.e_cap
        assert lay.meta.n_src == part.h_cap
        assert lay.meta.n_dst == part.rows_per_shard
        assert np.array_equal(a["src"][:k].numpy(), part.src_h[s, :k])
        assert np.array_equal(a["dst"][:k].numpy(), part.dst_l[s, :k])
        assert np.array_equal(a["mask"].numpy(), part.mask[s])
        # slot arrays: each real edge once, in its destination's run
        perm = lay.perm_blk.reshape(-1).numpy()
        real = perm < part.e_cap
        assert sorted(perm[real].tolist()) == list(range(part.e_cap))
        deg = (lay.row_end - lay.row_start).numpy()
        assert int(deg.max()) <= np.bincount(part.dst_l[s, :k]).max() \
            + -(-(part.e_cap - k) // part.rows_per_shard)
        halo = torch.from_numpy(part.halo[s]).long()
        ew_s = torch.zeros(part.e_cap)
        ew_s[:k] = ew[torch.from_numpy(part.perm[s, :k]).long()]
        got = tk.ops.spmm(x[halo], ew_s * a["mask"], lay)
        rows = part.rows_per_shard
        want = torch.cat([full, torch.zeros((part.n_nodes_padded
                                             - ds.n_nodes, 5))])
        assert torch.allclose(got, want[s * rows:(s + 1) * rows],
                              rtol=1e-6, atol=1e-6)
        by_rel = tk.ops.segment_sum(torch.ones(part.e_cap, 1),
                                    a["rel_runs"])[:, 0]
        assert by_rel.tolist() == np.bincount(
            part.rel[s], minlength=ds.n_relations).tolist()


_GOOD = ["data=4,model=2", "data=8", "model=2", "data=2,model=4",
         " data = 3 , model=1 ", "pod=2,data=2,model=2"]
_BAD = ["", "  ", "data", "data=", "data=x", "=4", "2x4", "data=0",
        "data=-2", "data=2,data=4", "da ta=2", "data=2,,model=2", None]


@pytest.mark.parametrize("spec", _GOOD + _BAD)
def test_mesh_spec_accepts_and_refuses_like_jax(spec):
    """The same strings parse to the same axes and print the same, and the
    same ones fail with the same message; the axis checks agree."""
    try:
        want = JMeshSpec.parse(spec)
    except JMeshSpecError as e:
        with pytest.raises(MeshSpecError) as got:
            MeshSpec.parse(spec)
        assert str(got.value) == str(e)
        assert issubclass(MeshSpecError, ValueError)
        return
    got = MeshSpec.parse(spec)
    assert got.axes == want.axes and str(got) == str(want)
    assert (got.names, got.shape, got.size, got.extent("model"),
            got.extent("pod")) == (want.names, want.shape, want.size,
                                   want.extent("model"), want.extent("pod"))
    for allowed, required in ((("data", "model"), ("data",)),
                              (("data",), ())):
        try:
            want.check_axes(allowed, required)
        except JMeshSpecError as e:
            with pytest.raises(MeshSpecError) as g:
                got.check_axes(allowed, required)
            assert str(g.value) == str(e)
        else:
            assert got.check_axes(allowed, required) is got
    with pytest.raises(MeshSpecError) as g:
        MeshSpec.from_shape((2, 2), ("pod", "data", "model"))
    with pytest.raises(JMeshSpecError) as j:
        JMeshSpec.from_shape((2, 2), ("pod", "data", "model"))
    assert str(g.value) == str(j.value)


def test_allreduce_byte_report_matches_jax(ds):
    """The analytic all-reduce payload of every KG model's parameters,
    int8 and fp32, on 1D and 2D meshes, with and without the placement:
    the JAX package's rows exactly."""
    for arch in ("kgat", "kgcn", "kgin"):
        step = build_step(arch, ds=ds, device="cpu", device_graph=False)
        params = step.init(0)
        shapes = {k: ([np.zeros(tuple(t.shape), np.float32) for t in v]
                      if isinstance(v, list)
                      else np.zeros(tuple(v.shape), np.float32))
                  for k, v in params.items()}
        for axes in ("data", ("data", "model")):
            for placement in (None, {"entity": "model"}):
                for compressed in (True, False):
                    want = jcompress.allreduce_byte_report(
                        shapes, axes, placement=placement,
                        compressed=compressed)
                    got = tcompress.allreduce_byte_report(
                        params, axes, placement=placement,
                        compressed=compressed)
                    assert got == want, (arch, axes, placement)
                    assert tcompress.allreduce_byte_report(
                        shapes, axes, placement=placement,
                        compressed=compressed) == want
    with pytest.raises(TypeError, match="placement= requires a dict"):
        tcompress.allreduce_byte_report([np.zeros(3)], "data",
                                        placement={"entity": "model"})


def test_allreduce_sent_bytes_count_int32_codes(ds):
    """What the port hands its all-reduce calls: four bytes an element on
    either wire (int8 codes travel widened to int32), plus one fp32 scale a
    leaf for int8's ``pmax``; the groups are the analytic report's."""
    step = build_step("kgat", ds=ds, device="cpu", device_graph=False)
    params = step.init(0)
    for axes, placement in (("data", None),
                            (("data", "model"), {"entity": "model"})):
        fp32 = tcompress.allreduce_byte_report(params, axes,
                                               placement=placement,
                                               compressed=False)
        for compressed in (True, False):
            sent = tcompress.allreduce_sent_bytes(
                params, axes, placement=placement, compressed=compressed)
            assert [r["params"] for r in sent] == [r["params"] for r in fp32]
            for s, f in zip(sent, fp32):
                n_leaves = len(tk.param_leaves(
                    {n: params[n] for n in s["params"]}))
                assert s["bytes"] == f["bytes"] + (
                    4 * n_leaves if compressed else 0)
                assert s["wire"] == ("int8" if compressed else "fp32")


@pytest.mark.parametrize("device,cards,rank,world,want", [
    ("cpu", 0, 1, 2, ("cpu", "gloo")),
    ("cuda", 1, 1, 2, ("cuda:0", "gloo")),      # ranks share the card
    ("cuda", 4, 1, 2, ("cuda:1", "nccl")),      # a card a rank
    ("cuda", 4, 3, 4, ("cuda:3", "nccl")),
])
def test_rank_device_picks_device_and_backend(monkeypatch, device, cards,
                                              rank, world, want):
    """A rank's device and backend: its own card and NCCL when there are
    cards enough, else every rank on ``cuda:0`` over gloo; the CPU gloo;
    ``cuda`` without a card raises, naming ``--device cpu``."""
    from repro_torch.launch.mesh import rank_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    dev, backend = rank_device(device, rank, world)
    assert (str(dev), backend) == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        rank_device("cuda", rank, world)


def test_named_errors_match_jax(ds):
    """``check_no_sampled_dp``, the missing-ShardSpec refusal and the
    step's contract errors say what the reference says."""
    for spec in ("data=2", "data=2,model=2"):
        with pytest.raises(NotImplementedError) as j:
            jdp.check_no_sampled_dp("fanout=3,2", mesh_spec=spec)
        with pytest.raises(NotImplementedError) as t:
            tdp.check_no_sampled_dp("fanout=3,2", mesh_spec=spec)
        assert str(t.value) == str(j.value)
    tdp.check_no_sampled_dp({"user": None})          # a batch passes
    bare = types.SimpleNamespace(arch="gcn-cora", dp_spec=None,
                                 dp_unsupported="no KG edges to split")
    with pytest.raises(NotImplementedError) as j:
        jdp._as_dp_spec(bare)
    with pytest.raises(NotImplementedError) as t:
        tdp._as_dp_spec(bare)
    assert str(t.value) == str(j.value)
    with pytest.raises(NotImplementedError, match="registered no ShardSpec"):
        tdp._as_dp_spec(types.SimpleNamespace(arch="x", dp_spec=None))
    part = tcsr.partition_edges([0, 1], [1, 2], n_nodes=8, n_shards=2)
    mesh = types.SimpleNamespace(shape={"data": 1})
    batch = {"user": np.zeros(3)}
    with pytest.raises(ValueError, match="partition built for 2 shards"):
        tdp._check_contract(part, mesh, "data", batch, 0, need_key=True)
    mesh2 = types.SimpleNamespace(shape={"data": 2})
    with pytest.raises(ValueError, match="batch 3 not divisible by 2"):
        tdp._check_contract(part, mesh2, "data", batch, 0, need_key=True)
    with pytest.raises(ValueError, match="needs a root seed"):
        tdp._check_contract(part, mesh2, "data", None, None, need_key=True)
    with pytest.raises(ValueError, match="per-step seed"):
        tcompress.all_reduce_grads({"w": torch.zeros(2)}, mesh2, "data")


def test_pad_unpad_row_sharded_state(ds):
    """``pad_row_sharded`` pads the entity table and its Adam moments (and
    nothing else) with zero rows to the 2D row space; ``unpad`` restores
    the state bit for bit; a wrong row count is refused."""
    from repro_torch.training.optimizer import adam

    step = build_step("kgat", ds=ds, device="cpu", device_graph=False)
    params = step.init(0)
    opt = adam(1e-3)
    state = (params, opt.init(params))
    part = tcsr.partition_edges(ds.src, ds.dst, ds.rel, n_nodes=ds.n_nodes,
                                n_shards=2)
    rp = tcsr.row_partition(ds.n_nodes, 3, pad_to=part.n_nodes_padded)
    padded = tdp.pad_row_sharded(state, step.dp_spec, part, 3)
    assert padded[0]["entity"].shape[0] == rp.n_rows_padded
    assert padded[0]["entity"].requires_grad
    assert not padded[0]["entity"][ds.n_nodes:].any()
    names = tdp._leaf_names(params)
    for key in ("mu", "nu"):
        for n, a, b in zip(names, padded[1][key], state[1][key]):
            assert a.shape[0] == (rp.n_rows_padded if n == "entity"
                                  else b.shape[0])
    back = tdp.unpad_row_sharded(padded, step.dp_spec, ds.n_nodes)
    assert all(torch.equal(a, b) for a, b in
               zip(tk.param_leaves(back[0]), tk.param_leaves(params)))
    with pytest.raises(ValueError, match="expected"):
        tdp.pad_row_sharded({"entity": torch.zeros(5, 2)}, ["entity"],
                            part, 3)
