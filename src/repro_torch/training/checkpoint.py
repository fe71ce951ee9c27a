"""Fault-tolerant checkpointing (port of ``repro/training/checkpoint.py``).

Layout per step, the reference's:  <dir>/step_<N:010d>/arrays.npz +
manifest.json

  * atomic: written to ``step_<N>.tmp``, then ``os.rename``d, so a crash
    mid-save never corrupts the latest good checkpoint;
  * keep-last-k garbage collection;
  * optional asynchronous save on a background thread (training goes on
    while the previous step serializes);
  * restore places the leaves on the devices, dtypes and ``requires_grad``
    flags of a caller-given template.

A tree is nested dicts (keys sorted, as ``jax.tree_util`` orders them),
lists and tuples over tensor, numpy-array and ``int`` leaves (Adam's
``"step"`` is an int and comes back as one). Leaves are stored as numpy
arrays ``leaf_<i>`` in that order.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "check_meta", "CheckpointManager", "RankCheckpoints"]


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:010d}")


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, int))


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves`` in order; return its
    structure as a string (``*`` for a leaf)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_flatten(v, leaves) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    if _is_leaf(tree):
        leaves.append(tree)
        return "*"
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")


def _host(x, *, copy: bool):
    """A leaf as a host value: numpy for tensors and arrays, the int as it
    is. ``copy`` makes a tensor's copy its own: on the CPU ``.numpy()``
    shares the live buffer, which the optimizer overwrites in place. A
    bfloat16 tensor is stored as its exact fp32 values (``_place`` rounds
    them back without loss)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:     # numpy has no bf16: exact fp32
            return x.to("cpu", torch.float32).numpy()
        return (x.to("cpu", copy=True) if copy else x.cpu()).numpy()
    if isinstance(x, np.ndarray):
        return x.copy() if copy else x
    return x


def _to_host(tree):
    """A copy of ``tree`` on the host, sharing no buffer with it (blocking
    device-to-host copies on the card)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return _host(tree, copy=True)


def save_checkpoint(base: str, step: int, tree, *, keep: int = 3,
                    meta: dict | None = None) -> str:
    """Synchronous atomic save; returns the checkpoint directory.

    ``meta`` is a JSON-serializable identity dict (arch id, model, schedule
    spec: ``training.step.step_metadata``) stored in the manifest;
    ``restore_checkpoint`` refuses a checkpoint whose stored identity
    contradicts the expected one.
    """
    os.makedirs(base, exist_ok=True)
    leaves: list = []
    treedef = _flatten(tree, leaves)
    arrays = [np.asarray(_host(x, copy=False)) for x in leaves]
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    manifest = {
        "step": step,
        "n_leaves": len(arrays),
        "treedef": treedef,
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": [str(a.dtype) for a in arrays],
    }
    if meta is not None:
        manifest["meta"] = meta
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(base, keep)
    return final


def _gc(base: str, keep: int) -> None:
    steps = sorted(_list_steps(base))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(base, s), ignore_errors=True)


def _list_steps(base: str) -> list[int]:
    if not os.path.isdir(base):
        return []
    out = []
    for name in os.listdir(base):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(base, name, "manifest.json")):
                out.append(int(name[5:]))
    return out


def latest_step(base: str) -> int | None:
    steps = _list_steps(base)
    return max(steps) if steps else None


def check_meta(stored: dict | None, expected: dict | None,
               where: str = "") -> None:
    """Refuse a checkpoint whose stored identity contradicts the run's.

    Only keys present in BOTH dicts are compared (checkpoints without
    metadata restore as before; extra keys on either side are
    informational, not contractual). The message is the reference's.
    """
    if not stored or not expected:
        return
    bad = {k: (stored[k], expected[k]) for k in stored
           if k in expected and stored[k] != expected[k]}
    if bad:
        detail = ", ".join(f"{k}: checkpoint={s!r} run={e!r}"
                           for k, (s, e) in sorted(bad.items()))
        hint = ""
        if "mesh" in bad or "placement" in bad:
            # a topology mismatch has a sanctioned migration path; name it
            hint = (" (for a mesh/placement change, launch.train's "
                    "--reshard-from gathers the old layout onto the new "
                    "mesh instead of resuming in place)")
        raise ValueError(
            f"checkpoint{' at ' + where if where else ''} was written for "
            f"a different run ({detail}); refusing a silent mismatch — "
            "point --ckpt at a fresh directory or match the original "
            "arch/schedule" + hint)


def _place(arr: np.ndarray, t):
    """One stored leaf on its template leaf's device, dtype and
    ``requires_grad`` flag: a fresh tensor, never the template's, in
    PyTorch's own allocation (an array read from the npz may sit off the
    alignment PyTorch gives its CPU tensors, and a vectorised CPU sum over
    it would then round in another order than over the tensor it was
    saved from)."""
    shape = tuple(t.shape) if hasattr(t, "shape") else ()
    if arr.shape != shape:
        raise ValueError(f"checkpoint leaf of shape {arr.shape} does not "
                         f"fit the template's {shape}")
    if isinstance(t, torch.Tensor):
        x = torch.empty(shape, dtype=t.dtype, device=t.device)
        x.copy_(torch.from_numpy(arr))
        return x.requires_grad_(t.requires_grad)
    if isinstance(t, np.ndarray):
        return arr.astype(t.dtype)
    return int(arr)


def _rebuild(t, it):
    if isinstance(t, dict):
        out = {k: _rebuild(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(v, it) for v in t)
    return _place(next(it), t)


def restore_checkpoint(base: str, template, *, step: int | None = None,
                       expect_meta: dict | None = None):
    """Restore onto ``template``'s structure, devices and dtypes.

    Returns ``(step, tree)``, or ``(None, template)`` when no checkpoint
    exists. ``expect_meta`` is validated against the manifest's stored
    metadata (``check_meta``).
    """
    if step is None:
        step = latest_step(base)
    if step is None:
        return None, template
    d = _step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    check_meta(manifest.get("meta"), expect_meta, where=d)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    t_leaves: list = []
    _flatten(template, t_leaves)
    if len(leaves) != len(t_leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template "
                         f"{len(t_leaves)}")
    with torch.no_grad():
        return step, _rebuild(template, iter(leaves))


class CheckpointManager:
    """Asynchronous keep-k checkpointing with one background writer thread.

    ``meta`` (``step_metadata(step, schedule_spec)``) is stamped into every
    save and enforced on every restore, so a checkpoint written for one
    arch or schedule cannot silently resume another. A failed background
    save raises from the next ``wait()`` (and so from the next ``save`` or
    ``restore``).
    """

    def __init__(self, base: str, *, keep: int = 3,
                 asynchronous: bool = True, meta: dict | None = None):
        self.base = base
        self.keep = keep
        self.asynchronous = asynchronous
        self.meta = meta
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _write(self, step: int, host_tree) -> None:
        try:
            save_checkpoint(self.base, step, host_tree, keep=self.keep,
                            meta=self.meta)
        except Exception as e:  # noqa: BLE001 (raised again by wait())
            self._error = e

    def save(self, step: int, tree) -> None:
        # copy to the host BEFORE handing the tree to the thread: the next
        # step overwrites the parameters and moments in place
        host_tree = _to_host(tree)
        self.wait()
        if self.asynchronous:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_tree), daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self.base, step, host_tree, keep=self.keep,
                            meta=self.meta)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template, *, step: int | None = None):
        self.wait()
        return restore_checkpoint(self.base, template, step=step,
                                  expect_meta=self.meta)


class RankCheckpoints:
    """A multi-rank run's checkpoints, with the ``CheckpointManager`` face
    the trainer calls (``save``, ``wait``, ``restore``).

    Checkpoints hold the full logical state, the same files a
    single-device run writes: ``to_logical(state)`` turns a rank's state
    into it (for a 2D mesh, the row blocks gathered over the ``model``
    ranks and cut to the real rows: a collective every rank calls), the
    root rank writes it, and ``to_local(state)`` turns a restored logical
    state back into this rank's. Every rank reads the files on restore
    (``logical_template`` gives their structure, devices and dtypes). ``meta`` carries the mesh and placement
    (``training.step.step_metadata``), so a checkpoint of another mesh is
    refused; ``launch.train --reshard-from`` restores one across meshes.
    Every rank calls ``restore`` at the same point (the start of a run, or
    the rollback after a step every rank saw fail): the root finishes its
    writes, then the ranks agree on the newest step over ``mesh`` (a max
    all-reduce), so all restore the same one."""

    def __init__(self, base: str, *, is_root: bool, to_logical, to_local,
                 logical_template, mesh, keep: int = 3,
                 meta: dict | None = None):
        self.inner = CheckpointManager(base, keep=keep, meta=meta)
        self.mesh = mesh
        self.is_root = is_root
        self.to_logical = to_logical
        self.to_local = to_local
        self.logical_template = logical_template

    def save(self, step: int, tree) -> None:
        full = self.to_logical(tree)
        if self.is_root:
            self.inner.save(step, full)

    def wait(self) -> None:
        if self.is_root:
            self.inner.wait()

    def restore(self, template, *, step: int | None = None):
        from repro_torch.sharding.comm import pmax

        self.wait()
        if step is None:
            newest = latest_step(self.inner.base)
            step = int(pmax(torch.tensor(
                [-1 if newest is None else newest], dtype=torch.int64,
                device=self.mesh.device), self.mesh,
                self.mesh.spec.names).item())
            if step < 0:
                return None, template
        got, full = restore_checkpoint(self.inner.base,
                                       self.logical_template, step=step,
                                       expect_meta=self.inner.meta)
        if got is None:
            return None, template
        return got, self.to_local(full)
