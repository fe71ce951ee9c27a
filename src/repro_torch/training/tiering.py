"""Two-tier entity table and the sampled-minibatch training loop (port of
``repro/training/tiering.py``).

Once batches are neighbour-sampled (``data.minibatch``) the entity table no
longer has to live on the card. Recommender-graph row access is skewed, so
the table splits into

  * a hot tier: the ``hot_frac`` most requested rows (ranked by in-degree
    at load, LFU-refreshed from live counts), on the card; and
  * a cold tier: the authoritative host copy, in pinned memory, read on
    demand.

``gather`` assembles a batch's row table on the card: each distinct row
once, the cold ones copied host to card from a pinned staging buffer on a
side CUDA stream (the default stream waits on the copy's event before it
reads them; a staging buffer is refilled only after its last copy has
finished), the hot ones copied card to card, then expanded to the batch's
positions (``index_select``). ``apply_grads`` is the sparse SGD
scatter-back: duplicate ids sum their gradients in a fixed order
(``ops.segment_sum`` over the runs of the host's ``np.unique`` inverse,
never ``index_add_``), hot rows update by ``index_put_`` at unique slots,
cold rows on the host. The ``tiering/*`` counters on the ``obs`` registry
count rows across the host-card boundary as the reference does, with its
power-of-two bucket padding: each cold transfer moves
``next_pow2(cold rows)`` rows, so ``rows_transferred`` is the sum of
``next_pow2`` of every event's ``cold_rows``.

``run_sampled_training`` gathers the next batch while the card runs the
current step, then repairs the overlap: after the scatter-back, the rows of
the prefetched table that were just updated are fetched again (``patch``),
so the loop gives the same bits as the sequential schedule
(``overlap=False``; DESIGN.md section 11.3).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.context import act_context
from repro_torch.data.csr import group_ids, segment_runs
from repro_torch.kernels import ops
from repro_torch.kernels.backend import full_fp32, resolve_device
from repro_torch.models.layers import param_leaves
from repro_torch.obs import get_registry, span
from repro_torch.training.optimizer import adam
from repro_torch.training.step import trainable

__all__ = ["TieredEmbeddingStore", "make_sampled_train_step",
           "run_sampled_training", "sampled_unsupported",
           "SampledTrainReport", "node_in_degree", "PHASES"]

PHASES = ("dispatch", "gather", "scatter", "patch")   # train/step/<phase>


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def node_in_degree(src, dst, rel, n_nodes: int) -> np.ndarray:
    """The initial hot ranking: in-degree, which uniform fanout sampling
    hits in proportion."""
    del src, rel
    return np.bincount(np.asarray(dst, np.int64),
                       minlength=n_nodes).astype(np.float64)


class TieredEmbeddingStore:
    """Card-hot / host-cold entity table with LFU refresh.

    The host table is authoritative for cold rows, the hot tier for hot rows
    (written back by ``refresh`` and ``flush``). ``stats`` and ``hit_rate``
    read the ``tiering/*`` registry counters (one label per store).
    """

    _SEQ = itertools.count()
    _STAT_KEYS = ("gathers", "rows_requested", "hot_hits",
                  "rows_transferred", "refreshes", "patch_rows",
                  "cold_rows")

    def __init__(self, table, freq: np.ndarray | None = None, *,
                 hot_frac: float = 0.1, refresh_every: int = 0,
                 lfu_decay: float = 0.5, registry=None, device="cuda"):
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        tab = torch.as_tensor(np.asarray(table, np.float32))
        n, d = tab.shape
        if not 0.0 <= hot_frac <= 1.0:
            raise ValueError(f"hot_frac must be in [0, 1], got {hot_frac}")
        self._host_t = torch.empty((n, d), dtype=torch.float32,
                                   pin_memory=self._cuda)
        self._host_t.copy_(tab)
        self._host = self._host_t.numpy()      # the same memory
        self.n_rows, self.dim = n, d
        self.n_hot = int(round(hot_frac * n))
        self.refresh_every = int(refresh_every)
        self.lfu_decay = float(lfu_decay)
        self._counts = (np.zeros(n, np.float64) if freq is None
                        else np.asarray(freq, np.float64).copy())
        self._hot_ids = np.empty(0, np.int64)
        self._hot_slot = np.full(n, -1, np.int64)
        self._hot = torch.zeros((0, d), device=self.device)
        # pinned staging: two buffers for host->card copies on the side
        # stream, each with the event of its last copy; one for card->host
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._up = [[None, None], [None, None]]
        self._up_next = 0
        self._down = None
        self._rebuild_hot()
        self._registry = registry if registry is not None else get_registry()
        label = f"tier{next(self._SEQ)}"
        self._m = {k: self._registry.counter(f"tiering/{k}", store=label)
                   for k in self._STAT_KEYS}

    @property
    def stats(self) -> dict:
        return {k: int(c.value) for k, c in self._m.items()}

    # -- tier management ----------------------------------------------------

    def _rebuild_hot(self) -> None:
        if self.n_hot:
            # stable ranking: frequency descending, id ascending
            order = np.lexsort((np.arange(self.n_rows), -self._counts))
            self._hot_ids = np.sort(order[: self.n_hot])
        else:
            self._hot_ids = np.empty(0, np.int64)
        self._hot_slot.fill(-1)
        self._hot_slot[self._hot_ids] = np.arange(len(self._hot_ids))
        self._hot = torch.from_numpy(self._host[self._hot_ids]).to(
            self.device)

    def flush(self) -> np.ndarray:
        """Write the hot rows back to the host; returns the whole
        (authoritative) table, which eval and checkpoints read."""
        if len(self._hot_ids):
            self._host[self._hot_ids] = self._hot.cpu().numpy()
        return self._host

    def refresh(self) -> None:
        """LFU re-rank: flush, decay the counts, rebuild the hot set."""
        self.flush()
        self._counts *= self.lfu_decay
        self._rebuild_hot()
        self._m["refreshes"].inc()

    # -- transfers ----------------------------------------------------------

    def _idx(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            self.device, non_blocking=True)

    def _upload(self, ids: np.ndarray) -> torch.Tensor:
        """The host rows ``ids`` on the card, moved as ``next_pow2`` rows
        (zeros past ``len(ids)``) from a pinned staging buffer on the side
        stream; the default stream waits for the copy."""
        n, bc = len(ids), _next_pow2(len(ids))
        if not self._cuda:
            vals = np.zeros((bc, self.dim), np.float32)
            vals[:n] = self._host[ids]
            return torch.from_numpy(vals)
        slot = self._up[self._up_next]
        self._up_next ^= 1
        buf, ev = slot
        if ev is not None:
            ev.synchronize()        # its last copy has left the buffer
        if buf is None or buf.shape[0] < bc:
            buf = torch.empty((bc, self.dim), dtype=torch.float32,
                              pin_memory=True)
        host = buf.numpy()
        np.take(self._host, ids, axis=0, out=host[:n])
        host[n:bc] = 0.0
        cur = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._side):
            vals = torch.empty((bc, self.dim), dtype=torch.float32,
                               device=self.device)
            vals.copy_(buf[:bc], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._side)
        cur.wait_event(ev)
        vals.record_stream(cur)
        slot[0], slot[1] = buf, ev
        return vals

    def _download(self, rows: torch.Tensor) -> np.ndarray:
        """``rows`` (card) to the host through a pinned buffer."""
        if not self._cuda:
            return rows.numpy()
        if self._down is None or self._down.shape[0] < rows.shape[0]:
            self._down = torch.empty((rows.shape[0], self.dim),
                                     dtype=torch.float32, pin_memory=True)
        out = self._down[:rows.shape[0]]
        out.copy_(rows)
        return out.numpy()

    def _scatter_rows(self, out: torch.Tensor, rows: np.ndarray,
                      targets: np.ndarray, *, count: bool) -> torch.Tensor:
        """``out[targets] = table[rows]`` through the tiers (in place;
        ``targets`` unique)."""
        slots = self._hot_slot[rows]
        cold = np.nonzero(slots < 0)[0]
        hot = np.nonzero(slots >= 0)[0]
        if len(cold):
            vals = self._upload(rows[cold])
            out[self._idx(targets[cold])] = vals[:len(cold)]
            if count:
                self._m["rows_transferred"].inc(_next_pow2(len(cold)))
                self._m["cold_rows"].inc(len(cold))
        if len(hot):
            out[self._idx(targets[hot])] = self._hot[self._idx(slots[hot])]
        return out

    # -- gather / scatter ---------------------------------------------------

    def gather(self, rows: np.ndarray,
               requests: np.ndarray | None = None) -> torch.Tensor:
        """The card's row table for global ids ``rows`` (duplicates fine):
        each distinct row crosses the boundary at most once, then expands
        to its positions. ``requests`` is the access stream the LFU counts
        and the hit rate are measured over (default ``rows``)."""
        rows = np.asarray(rows, np.int64)
        req = rows if requests is None else np.asarray(requests, np.int64)
        np.add.at(self._counts, req, 1.0)
        self._m["gathers"].inc()
        self._m["rows_requested"].inc(len(req))
        self._m["hot_hits"].inc(int((self._hot_slot[req] >= 0).sum()))
        uniq, _, inv, _, _ = group_ids(rows, self.n_rows)
        ut = torch.empty((len(uniq), self.dim), dtype=torch.float32,
                         device=self.device)
        ut = self._scatter_rows(ut, uniq, np.arange(len(uniq)), count=True)
        out = ut.index_select(0, self._idx(inv))
        if self.refresh_every and \
                int(self._m["gathers"].value) % self.refresh_every == 0:
            self.refresh()
        return out

    def patch(self, out: torch.Tensor, rows: np.ndarray,
              updated: np.ndarray) -> torch.Tensor:
        """Repair a prefetched gather in place: fetch again the positions
        of ``rows`` whose ids are in ``updated`` (just scattered back), so
        ``out`` equals a gather made after the update."""
        rows = np.asarray(rows, np.int64)
        touched = np.zeros(self.n_rows, bool)
        touched[updated] = True
        idx = np.nonzero(touched[rows])[0]
        if not len(idx):
            return out
        self._m["patch_rows"].inc(len(idx))
        return self._scatter_rows(out, rows[idx], idx, count=True)

    def apply_grads(self, rows: np.ndarray, grads: torch.Tensor,
                    lr: float) -> np.ndarray:
        """Sparse SGD for the touched rows: ``row -= lr * Σ grad`` over the
        positions of each id, summed in position order (the fixed-order
        segment sum); each updated cold row crosses the boundary once.
        Returns the unique global ids updated (the patch set)."""
        rows = np.asarray(rows, np.int64)
        # the positions of each id in position order: the stable sort
        uniq, _, _, order, counts = group_ids(rows, self.n_rows)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])

        runs = (segment_runs(order, start, start + counts, len(uniq),
                             len(rows), self.device),)
        delta = ops.segment_sum((-lr) * grads.to(torch.float32), runs)
        slots = self._hot_slot[uniq]
        cold = np.nonzero(slots < 0)[0]
        hot = np.nonzero(slots >= 0)[0]
        if len(hot):
            sl = self._idx(slots[hot])
            self._hot[sl] = self._hot[sl] + delta[self._idx(hot)]
        if len(cold):
            bc = _next_pow2(len(cold))
            src = np.zeros(bc, np.int64)
            src[: len(cold)] = cold
            d_host = self._download(delta[self._idx(src)])[: len(cold)]
            self._host[uniq[cold]] += d_host
            self._m["rows_transferred"].inc(bc)
            self._m["cold_rows"].inc(len(cold))
        return uniq

    # -- accounting ---------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        req = self._m["rows_requested"].value
        return self._m["hot_hits"].value / req if req else 0.0

    @property
    def rows_transferred_per_step(self) -> float:
        g = self._m["gathers"].value
        return self._m["rows_transferred"].value / g if g else 0.0

    @property
    def device_bytes(self) -> int:
        return int(self._hot.numel()) * 4

    @property
    def table_bytes(self) -> int:
        return int(self._host.size) * 4


# -- sampled train step and loop ----------------------------------------------


def make_sampled_train_step(step, opt, *, schedule=None,
                            root_seed: int | None = None):
    """``train_step(state, rows, view, i) -> (state, row_grads, metrics)``
    for sampled batches. ``state = (dense_params, opt_state)`` leaves the
    entity table out (the tier store holds it); ``rows`` is the gathered
    table of the batch's outermost frontier. Each call enters
    ``act_context(schedule, root_seed, step=i)``: the
    same scopes, policies and rounding seeds as the full-graph step.
    ``metrics`` holds the loss and ``act``, the report of the residuals the
    step saved."""
    from repro_torch.models.kgnn import sampled_bpr_loss

    cfg = step.cfg

    def train_step(state, rows, view, i):
        dense, opt_state = state
        rows = rows.detach().requires_grad_(True)
        ctx = act_context(schedule, root_seed, step=i)
        with full_fp32():
            with ctx:
                loss = sampled_bpr_loss({**dense, "entity": rows}, view, cfg)
            grads = torch.autograd.grad(loss, param_leaves(dense) + [rows])
        dense, opt_state = opt.update(grads[:-1], opt_state, dense)
        return (dense, opt_state), grads[-1], {"loss": loss.detach(),
                                               "act": ctx.report()}

    return train_step


@dataclasses.dataclass
class SampledTrainReport:
    losses: list
    hit_rate: float
    rows_transferred_per_step: float
    peak_device_bytes: int          # max_memory_allocated; 0 on the CPU
    store_device_bytes: int
    table_bytes: int
    step_ms: float                  # mean wall time a step
    n_steps: int
    stats: dict
    step_ms_p99: float = 0.0
    step_ms_all: list = dataclasses.field(default_factory=list)
    phase_ms: dict = dataclasses.field(default_factory=dict)  # PHASES
    act: dict = dataclasses.field(default_factory=dict)   # step 0's report


def sampled_unsupported(arch: str, family: str) -> str:
    """Why ``arch`` of ``family`` has no sampled path (the reference's
    refusal): only the KG family binds a KG dataset to sample from."""
    return (f"sampled minibatch training (--sample) is defined for the "
            f"kgnn family with a bound KG dataset; arch {arch!r} "
            f"(family {family!r}) has none. Train it full-batch instead "
            f"(drop --sample).")


def run_sampled_training(step, *, fanouts: tuple[int, ...], steps: int = 50,
                         batch_size: int = 256, hot_frac: float = 0.1,
                         refresh_every: int = 16, schedule=None,
                         root_seed: int | None = None, seed: int = 0,
                         params: dict | None = None, overlap: bool = True,
                         log_fn: Callable | None = None):
    """Train a KG ``ModelStep`` (built with ``device_graph=False``) on
    sampled minibatches, on the step's device.

    Per step: (1) dispatch step k (the card runs it asynchronously);
    (2) take batch k+1 from the sampler thread, move its blocks to the card
    and gather its rows, overlapping the step; (3) scatter step k's row
    gradients back (the first wait on the card); (4) ``patch`` the
    prefetched table. With ``overlap=False`` the gather of batch k+1 comes
    after the scatter-back and there is no patch: the same bits.

    Parameters come from ``params`` (a dict like ``init_params``'s, on any
    device) or ``init_params(seed=0)``; the entity table goes to
    the store's host tier before the first step. Dense parameters train
    under Adam at ``step.lr``, entity rows under SGD at the same rate. Returns ``(report, dense_params, store)``;
    ``store.flush()`` is the whole entity table.
    """
    from repro_torch.data.minibatch import MinibatchStream
    from repro_torch.models import kgnn

    if step.family != "kgnn" or "dataset" not in step.data:
        raise ValueError(sampled_unsupported(step.arch, step.family))
    cfg = step.cfg
    if cfg.n_layers != len(fanouts):
        raise ValueError(
            f"--sample needs one fanout per layer: model has "
            f"{cfg.n_layers} layers but got fanouts {tuple(fanouts)} "
            f"(pass e.g. --sample fanout="
            f"{','.join(['10'] * cfg.n_layers)})")
    ds = step.data["dataset"]
    dev = step.data["device"]
    if params is None:
        params = kgnn.init_params(cfg, seed=0, device="cpu")
    params = dict(params)
    # the entity table goes to the host now; the card holds the hot tier
    # and the gathered batch rows only
    entity = params.pop("entity").detach().cpu().numpy()
    dense = trainable({k: [w.to(dev) for w in v] if isinstance(v, list)
                       else v.to(dev) for k, v in params.items()})
    store = TieredEmbeddingStore(
        entity, node_in_degree(ds.src, ds.dst, ds.rel, ds.n_nodes),
        hot_frac=hot_frac, refresh_every=refresh_every, device=dev)
    del entity
    lr = step.lr
    opt = adam(lr)
    state = (dense, opt.init(dense))
    train_step = make_sampled_train_step(step, opt, schedule=schedule,
                                         root_seed=root_seed)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, act = [], [], {}
    phase_ms = {p: [] for p in PHASES}
    hist = get_registry().histogram("train/step_ms", arch=step.arch,
                                    mode="sampled")

    @contextlib.contextmanager
    def phase(name):
        t0 = time.perf_counter()
        with span(f"train/step/{name}"):
            yield
        phase_ms[name].append((time.perf_counter() - t0) * 1e3)

    def fetch(stream):
        it = stream.next()
        return it, it.view.to(dev), store.gather(it.input_nodes,
                                                 it.requests)

    t_all = time.perf_counter()
    with MinibatchStream(ds, tuple(fanouts), batch_size=batch_size,
                         seed=seed, pin=cuda) as stream:
        item, view, rows = fetch(stream)
        for t in range(steps):
            ts = time.perf_counter()
            with span("train/step", step=t):
                with phase("dispatch"):
                    state, g_rows, metrics = train_step(state, rows, view, t)
                if overlap:
                    with phase("gather"):      # overlaps the step
                        nxt, nview, pre = fetch(stream)
                with phase("scatter"):
                    updated = store.apply_grads(item.input_nodes, g_rows, lr)
                if overlap:
                    with phase("patch"):
                        pre = store.patch(pre, nxt.input_nodes, updated)
                else:
                    with phase("gather"):
                        nxt, nview, pre = fetch(stream)
                losses.append(float(metrics["loss"]))
                if t == 0:
                    act = metrics["act"]
            dt = (time.perf_counter() - ts) * 1e3
            step_ms.append(dt)
            hist.observe(dt)
            if log_fn is not None and (t % 10 == 0 or t == steps - 1):
                log_fn(f"step {t:4d}  loss {losses[-1]:.4f}  "
                       f"hit {store.hit_rate:.2%}")
            item, view, rows = nxt, nview, pre
    mean_ms = (time.perf_counter() - t_all) * 1e3 / max(steps, 1)
    report = SampledTrainReport(
        losses=losses, hit_rate=store.hit_rate,
        rows_transferred_per_step=store.rows_transferred_per_step,
        peak_device_bytes=torch.cuda.max_memory_allocated(dev) if cuda else 0,
        store_device_bytes=store.device_bytes, table_bytes=store.table_bytes,
        step_ms=mean_ms, n_steps=steps, stats=dict(store.stats),
        step_ms_p99=float(np.percentile(step_ms, 99)) if step_ms else 0.0,
        step_ms_all=step_ms, phase_ms=phase_ms, act=act)
    return report, state[0], store
