"""The training loop (port of ``repro/training/trainer.py``, without
checkpoints).

``Trainer`` drives ``train_step(state, batch, i) -> (state, metrics)`` over
a data iterator fed by a background ``PrefetchIterator`` (the straggler
guard: a batch that does not arrive within ``fetch_timeout_s`` raises). It
keeps one record per step: the step's wall time and its metrics, tensors
read as floats. Reading the loss waits for the device, so the wall time is
the step's time, not its enqueue. Checkpoint save/restore and replay are
not ported yet: a ``ckpt_dir`` raises.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterator

import torch

__all__ = ["TrainerConfig", "Trainer", "PrefetchIterator"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    log_every: int = 50
    fetch_timeout_s: float = 30.0
    ckpt_dir: str | None = None   # not ported yet: raises when set


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


class Trainer:
    """Runs ``cfg.total_steps`` steps; ``history`` holds one record per step
    (``step``, ``seconds`` and the step's metrics)."""

    def __init__(self, train_step: Callable, state, data_iter: Iterator,
                 cfg: TrainerConfig, *, log_fn: Callable = print):
        if cfg.ckpt_dir is not None:
            raise NotImplementedError(
                "checkpoint save/restore and replay are not ported yet "
                "(ROADMAP Queue 1, slice 2 deferred items)")
        self.train_step = train_step
        self.state = state
        self.cfg = cfg
        self.data_iter = data_iter
        self.log = log_fn
        self.history: list[dict] = []

    def run(self):
        data = PrefetchIterator(self.data_iter,
                                timeout_s=self.cfg.fetch_timeout_s)
        try:
            for i in range(self.cfg.total_steps):
                try:
                    batch = data.next()
                except StopIteration:
                    break
                t0 = time.perf_counter()
                self.state, metrics = self.train_step(self.state, batch, i)
                record = {k: _scalar(v) for k, v in metrics.items()}
                record.update(step=i + 1, seconds=time.perf_counter() - t0)
                self.history.append(record)
                if (i + 1) % self.cfg.log_every == 0:
                    self.log(f"[trainer] step {i + 1}: loss "
                             f"{record.get('loss', float('nan')):.6f} "
                             f"({record['seconds'] * 1e3:.1f} ms)")
        finally:
            data.close()   # do not leak the prefetch producer
        return self.state
