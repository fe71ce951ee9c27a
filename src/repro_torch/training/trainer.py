"""Fault-tolerant training loop (port of ``repro/training/trainer.py``).

  * checkpoint/restart: periodic asynchronous checkpoints
    (``training.checkpoint``); on a step failure the loop restores the last
    good checkpoint and goes on from there. The rounding seeds are keyed by
    the global step, so step ``i`` from the state restored at ``i``, on the
    same batch, gives the same bits (the data iterator is not rewound, as in
    the reference: a replayed step takes the next batch).
  * bounded retries: ``max_failures`` consecutive failures abort. A failure
    with no checkpoint to roll back to (no ``ckpt_dir``, or none saved yet)
    raises at once: the optimizer updates the state in place, so a failed
    step may have left it half updated, and a retry from there would not be
    the step that it claims to be.
  * straggler guard: the host data queue has a fetch timeout
    (``PrefetchIterator``), and a step three times slower than the EMA of
    step times is logged.
  * telemetry: ``train`` / ``train/step`` / ``train/step/data`` /
    ``train/step/update`` spans (``obs``), the ``train/steps``,
    ``train/step_ms``, ``train/loss`` and ``train/edges_per_sec`` series
    in the metrics registry, and an optional ``StepLogWriter``.

``history`` keeps one record per step of the final trajectory: the step's
wall time and its metrics, tensors read as floats (a rollback drops the
records past the restored step). Reading the loss waits for the device, so
the wall time is the step's time, not its enqueue.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterator

import torch

from repro_torch.obs import get_registry, log as obs_log, span, step_span

from .checkpoint import CheckpointManager

__all__ = ["TrainerConfig", "Trainer", "PrefetchIterator"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str | None = None   # None: no checkpoints and no rollback
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 50
    max_failures: int = 3
    fetch_timeout_s: float = 30.0


class PrefetchIterator:
    """Background-thread prefetch with a fetch timeout.

    ``close()`` stops the producer: its puts re-check the done flag on a
    bounded timeout, so a producer blocked on a full queue sees shutdown
    instead of outliving the trainer.
    """

    _PUT_POLL_S = 0.05

    def __init__(self, it: Iterator, depth: int = 2,
                 timeout_s: float = 30.0):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._timeout = timeout_s
        self._done = False

        def worker():
            try:
                for item in it:
                    if not self._put(item):
                        return
                self._put(StopIteration)
            except Exception as e:  # noqa: BLE001 (handed to the consumer)
                self._put(e)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._done:
            try:
                self._q.put(item, timeout=self._PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def next(self):
        item = self._q.get(timeout=self._timeout)
        if item is StopIteration:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self, join_timeout_s: float = 5.0):
        """Stop the producer thread and drain pending items."""
        self._done = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=join_timeout_s)


def _scalar(v):
    return float(v) if isinstance(v, torch.Tensor) else v


def _number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class Trainer:
    """Drives ``train_step(state, batch, step) -> (state, metrics)`` from
    ``self.step`` to ``cfg.total_steps``.

    ``state`` is a tree of tensors and ints (parameters and optimizer
    state); ``ckpt_meta`` (``training.step.step_metadata``) rides in every
    checkpoint manifest and is enforced on restore. ``failure_injector``
    (``fn(step) -> bool``) raises an injected failure before a step, for
    tests.
    """

    def __init__(self, train_step: Callable, state, data_iter: Iterator,
                 cfg: TrainerConfig, *, log_fn: Callable | None = None,
                 ckpt_meta: dict | None = None, step_writer=None,
                 items_per_step: int | None = None):
        self.train_step = train_step
        self.state = state
        self.cfg = cfg
        self.data_iter = data_iter
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep=cfg.keep,
                                       meta=ckpt_meta)
                     if cfg.ckpt_dir is not None else None)
        # progress lines go to stderr through the leveled obs log
        self.log = log_fn if log_fn is not None else obs_log
        self.step = 0
        self.history: list[dict] = []
        self._failures = 0
        self._step_ema: float | None = None
        self.failure_injector: Callable | None = None
        self.step_writer = step_writer
        self.items_per_step = items_per_step
        reg = get_registry()
        self._m_steps = reg.counter("train/steps")
        self._m_step_ms = reg.histogram("train/step_ms")
        self._m_loss = reg.gauge("train/loss")
        self._m_tput = (reg.gauge("train/edges_per_sec")
                        if items_per_step else None)

    def restore_if_available(self) -> "Trainer":
        if self.ckpt is not None:
            step, state = self.ckpt.restore(self.state)
            if step is not None:
                self.step, self.state = step, state
                self.log(f"[trainer] restored checkpoint at step {step}")
        return self

    def run(self):
        self.log(f"[trainer] start step {self.step}/{self.cfg.total_steps}")
        data = PrefetchIterator(self.data_iter,
                                timeout_s=self.cfg.fetch_timeout_s)
        try:
            with span("train"):
                return self._run(data)
        finally:
            data.close()   # do not leak the prefetch producer

    def _rollback(self) -> bool:
        """Restore the last checkpoint; False when there is none."""
        if self.ckpt is None:
            return False
        step, state = self.ckpt.restore(self.state)
        if step is None:
            return False
        self.step, self.state = step, state
        self.history = [r for r in self.history if r["step"] <= step]
        self.log(f"[trainer] rolled back to step {step}")
        return True

    def _run(self, data: PrefetchIterator):
        cfg = self.cfg
        while self.step < cfg.total_steps:
            try:
                with step_span("train/step", self.step):
                    with span("train/step/data"):
                        batch = data.next()
                    if self.failure_injector is not None and \
                            self.failure_injector(self.step):
                        raise RuntimeError(
                            f"injected failure at step {self.step}")
                    t0 = time.perf_counter()
                    with span("train/step/update"):
                        self.state, metrics = self.train_step(
                            self.state, batch, self.step)
                        record = {k: _scalar(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                self._step_ema = dt if self._step_ema is None else \
                    0.9 * self._step_ema + 0.1 * dt
                self._m_steps.inc()
                self._m_step_ms.observe(dt * 1e3)
                if self._m_tput is not None and dt > 0:
                    self._m_tput.set(self.items_per_step / dt)
                if dt > 3.0 * self._step_ema and self.step > 10:
                    self.log(f"[trainer] straggler step {self.step}: "
                             f"{dt:.3f}s vs ema {self._step_ema:.3f}s")
                self.step += 1
                self._failures = 0
                scalars = {k: v for k, v in record.items() if _number(v)}
                record.update(step=self.step, seconds=dt)
                self.history.append(record)
                row = ({"step": self.step, "wall_ms": round(dt * 1e3, 4)}
                       if self.step_writer is not None else None)
                if self.step % cfg.log_every == 0:
                    self.log(f"[trainer] step {self.step}: {scalars} "
                             f"({dt * 1e3:.1f} ms)")
                    if "loss" in scalars:
                        self._m_loss.set(scalars["loss"])
                    if row is not None:
                        row.update(scalars)
                if row is not None:
                    self.step_writer.write(row)
                if self.ckpt is not None and self.step % cfg.ckpt_every == 0:
                    self.ckpt.save(self.step, self.state)
            except StopIteration:
                break
            except Exception as e:  # noqa: BLE001 (fault tolerance boundary)
                self._failures += 1
                self.log(f"[trainer] step {self.step} failed "
                         f"({self._failures}/{cfg.max_failures}): {e!r}")
                if self._failures >= cfg.max_failures:
                    raise
                if not self._rollback():
                    self.log("[trainer] no checkpoint to roll back to")
                    raise
        if self.ckpt is not None:
            self.ckpt.save(self.step, self.state)
            self.ckpt.wait()
        return self.state
