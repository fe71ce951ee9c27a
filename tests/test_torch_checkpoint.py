"""The port's checkpoints, fault-tolerant trainer, launcher and ``obs``
sinks, on the CPU.

- ``training.checkpoint``: the reference's on-disk layout, keep-k garbage
  collection, an asynchronous save that does not see a later in-place
  update, and ``check_meta`` refusing what the reference's refuses, with the
  same message.
- ``training.trainer``: rollback and replay after an injected failure,
  abort after ``max_failures``, resume of a finished run; a replayed KGAT
  step (restored from disk into a fresh trainer, same batch) gives the same
  loss, parameters and Adam moments bit for bit, at FP32 and INT2.
- ``launch.train.main`` in process with ``--ckpt``, ``--metrics-out`` and
  ``--trace``: a second run resumes, its ``summary.json`` passes both
  packages' validators, and a restore under another arch is refused.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from repro.obs import validate_summary as jvalidate_summary
from repro.training.checkpoint import check_meta as jcheck_meta
from repro_torch.configs import get
from repro_torch.configs.smoke import reduced
from repro_torch.core.policy import schedule_from_cli
from repro_torch.launch import train as tlaunch
from repro_torch.launch.serve import reduced_dataset
from repro_torch.models.layers import param_leaves
from repro_torch.models.registry import build_step
from repro_torch.obs import get_tracer, validate_summary
from repro_torch.training import checkpoint as ck
from repro_torch.training.optimizer import adam
from repro_torch.training.step import make_train_step, step_metadata, \
    trainable
from repro_torch.training.trainer import Trainer, TrainerConfig


def _tree(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": [torch.randn((3, 2), generator=g).requires_grad_(True)],
              "entity": torch.randn((5, 2), generator=g)
              .requires_grad_(True)}
    return params, {"step": 7, "mu": [torch.randn((5, 2), generator=g)],
                    "nu": [torch.rand((3, 2), generator=g)]}


def _leaves(state):
    params, opt = state
    return param_leaves(params) + opt["mu"] + opt["nu"]


def _assert_same(a, b):
    assert a[1]["step"] == b[1]["step"]
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert torch.equal(x, y)


def test_round_trip_layout_and_keep_k(tmp_path):
    state = _tree()
    for step in (1, 2, 3, 4):
        ck.save_checkpoint(str(tmp_path), step, state, keep=2,
                           meta={"arch": "kgat"})
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]
    assert sorted(os.listdir(tmp_path / "step_0000000004")) == \
        ["arrays.npz", "manifest.json"]
    man = json.loads((tmp_path / "step_0000000004" / "manifest.json")
                     .read_text())
    assert man["n_leaves"] == 5 and man["meta"] == {"arch": "kgat"}
    # leaves in sorted-key order, as jax.tree_util flattens a dict
    assert man["shapes"] == [[5, 2], [3, 2], [5, 2], [3, 2], []]
    assert ck.latest_step(str(tmp_path)) == 4
    step, got = ck.restore_checkpoint(str(tmp_path), _tree(1))
    assert step == 4
    _assert_same(got, state)
    assert type(got[1]["step"]) is int
    assert all(t.requires_grad for t in param_leaves(got[0]))
    assert not got[1]["mu"][0].requires_grad
    empty = _tree(1)
    assert ck.restore_checkpoint(str(tmp_path / "none"), empty) == \
        (None, empty)
    with pytest.raises(ValueError, match="does not fit"):
        ck.restore_checkpoint(str(tmp_path), ({"w": [torch.zeros(3, 3)],
                                               "entity": torch.zeros(5, 2)},
                                              _tree()[1]))


def test_async_save_does_not_see_a_later_update(tmp_path, monkeypatch):
    """The update that follows ``save`` runs before the writer thread
    writes; the checkpoint still holds the state as it was at ``save``."""
    go = threading.Event()
    write = ck.save_checkpoint

    def held(*a, **kw):
        assert go.wait(timeout=30)
        return write(*a, **kw)

    monkeypatch.setattr(ck, "save_checkpoint", held)
    state = _tree()
    want = [t.detach().clone() for t in _leaves(state)]
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    with torch.no_grad():
        for t in _leaves(state):
            t.add_(1.0)                # the optimizer updates in place
    go.set()
    mgr.wait()
    _, got = mgr.restore(_tree(1))
    for x, y in zip(_leaves(got), want, strict=True):
        assert torch.equal(x, y)


META = {"arch": "kgat", "family": "kgnn", "model": "kgat",
        "schedule": "int2"}


@pytest.mark.parametrize("stored,expected,where", [
    (None, META, ""),
    (META, None, ""),
    ({}, META, ""),
    (META, dict(META), "d"),
    ({"arch": "kgat"}, {"schedule": "int8"}, ""),
    (META, {**META, "extra": 1}, ""),
    (META, {**META, "arch": "kgcn", "model": "kgcn"}, "ck/step_0000000004"),
    (META, {**META, "schedule": "int8"}, ""),
    ({**META, "mesh": "data=2"}, {**META, "mesh": "data=4"}, "d"),
    ({**META, "placement": "a"}, {**META, "placement": "b"}, ""),
])
def test_check_meta_refuses_as_the_reference(stored, expected, where):
    def outcome(fn):
        try:
            fn(stored, expected, where=where)
        except ValueError as e:
            return str(e)
        return None

    ref = outcome(jcheck_meta)
    assert outcome(ck.check_meta) == ref
    bad = bool(stored) and bool(expected) and any(
        k in expected and stored[k] != expected[k] for k in stored)
    assert (ref is not None) == bad


def _toy(tmp_path, name, total):
    """A trainer over a two-leaf state whose step adds the batch; no
    checkpoints when ``name`` is None."""
    def step(state, batch, i):
        w, opt = state
        with torch.no_grad():
            w["x"].add_(batch)
        return (w, {"step": opt["step"] + 1}), {"loss": w["x"].sum()}

    data = iter([torch.full((2,), float(i)) for i in range(1, 20)])
    logs: list[str] = []
    tr = Trainer(step, ({"x": torch.zeros(2)}, {"step": 0}), data,
                 TrainerConfig(total_steps=total,
                               ckpt_dir=(None if name is None
                                         else str(tmp_path / name)),
                               ckpt_every=2, log_every=1, max_failures=3,
                               fetch_timeout_s=5.0),
                 log_fn=logs.append)
    return tr, logs


def test_trainer_recovers_aborts_and_resumes(tmp_path):
    tr, logs = _toy(tmp_path, "a", 5)
    failed = set()

    def inject(step):
        if step == 3 and step not in failed:
            failed.add(step)
            return True
        return False

    tr.failure_injector = inject
    w, opt = tr.run()
    assert any("rolled back to step 2" in m for m in logs)
    # the rollback drops batch 3's step and the failed attempt took batch
    # 4 (the iterator is not rewound): steps 3-5 take batches 5-7
    assert tr.step == 5 and opt["step"] == 5
    assert [r["step"] for r in tr.history] == [1, 2, 3, 4, 5]
    assert float(w["x"][0]) == 1 + 2 + 5 + 6 + 7
    assert ck.latest_step(str(tmp_path / "a")) == 5

    again, logs = _toy(tmp_path, "a", 5)
    again.restore_if_available().run()
    assert again.step == 5 and not again.history
    assert any("restored checkpoint at step 5" in m for m in logs)

    stuck, logs = _toy(tmp_path, "b", 5)
    stuck.failure_injector = lambda s: s == 2     # again after each rollback
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        stuck.run()
    assert sum("failed" in m for m in logs) == 3


@pytest.mark.parametrize("name", [None, "c"])
def test_trainer_raises_when_nothing_to_roll_back_to(tmp_path, name):
    """With no checkpoint directory, or before the first checkpoint, a
    failed step raises at once: the state may be half updated in place."""
    tr, logs = _toy(tmp_path, name, 5)
    tr.failure_injector = lambda s: s == 1
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        tr.run()
    assert sum("failed" in m for m in logs) == 1
    assert any("no checkpoint to roll back to" in m for m in logs)
    assert tr.step == 1 and [r["step"] for r in tr.history] == [1]


@pytest.mark.parametrize("bits", [0, 2])
def test_replayed_kgat_step_bit_identical(tmp_path, bits):
    """Step 3 taken from the step-2 checkpoint, restored from disk into a
    fresh trainer, on step 3's batch: the same loss, parameters and
    moments, bit for bit."""
    cfg = reduced(get("kgat")).model_cfg
    step = build_step("kgat", ds=reduced_dataset(cfg), cfg=cfg,
                      batch_size=32, device="cpu")
    opt = adam(step.lr)
    train = make_train_step(step, opt, root_seed=1,
                            schedule=schedule_from_cli(None, bits))
    meta = step_metadata(step, f"int{bits}")
    batches = [b for _, b in zip(range(3), step.batches())]

    def trainer(name, data):
        p = trainable(step.init(0))
        return Trainer(train, (p, opt.init(p)), iter(data),
                       TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path
                                                                 / name),
                                     ckpt_every=2, log_every=10),
                       ckpt_meta=meta, log_fn=lambda _: None)

    first = trainer("a", batches)
    state = first.run()
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_0000000002",
                    tmp_path / "b" / "step_0000000002")
    replay = trainer("b", batches[2:]).restore_if_available()
    assert replay.step == 2
    again = replay.run()
    assert [r["step"] for r in replay.history] == [3]
    assert np.float32(replay.history[0]["loss"]) == \
        np.float32(first.history[2]["loss"])
    _assert_same(again, state)


def test_launcher_resumes_writes_sinks_and_refuses(tmp_path, capsys):
    ckpt, out = str(tmp_path / "ckpt"), tmp_path / "m"
    argv = ["--arch", "kgcn", "--bits", "2", "--batch", "64", "--device",
            "cpu", "--ckpt", ckpt, "--metrics-out", str(out), "--trace",
            str(out / "trace.json")]
    tlaunch.main(argv + ["--steps", "4"])
    assert ck.latest_step(ckpt) == 4
    tlaunch.main(argv + ["--steps", "8"])
    captured = capsys.readouterr()
    assert "restored checkpoint at step 4" in captured.err
    assert "done; loss" in captured.out and "x vs fp32" in captured.out
    assert not get_tracer().enabled
    rows = [json.loads(x) for x in (out / "steps.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == [5, 6, 7, 8]
    assert len({r["act_total_bytes"] for r in rows}) == 1
    summary = json.loads((out / "summary.json").read_text())
    validate_summary(summary)
    jvalidate_summary(summary)
    assert summary["run"]["kind"] == "train"
    # the second run's series alone: main empties the registry first
    assert summary["histograms"]["train/step_ms"]["count"] == 4
    assert summary["counters"]["train/steps"] == 4
    assert summary["gauges"]["act/total_bytes"] == rows[0]["act_total_bytes"]
    names = {e["name"] for e in json.loads((out / "trace.json").read_text())
             ["traceEvents"]}
    assert {"train", "train/step", "train/step/data",
            "train/step/update"} <= names
    with pytest.raises(ValueError, match="written for a different run"):
        tlaunch.main(["--arch", "kgin", "--steps", "8", "--device", "cpu",
                      "--bits", "2", "--ckpt", ckpt])
