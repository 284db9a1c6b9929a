"""Host-resident population store: O(cohort) device memory for cohort
rounds (the port of ``src/repro/core/popstore.py``).

The cohort engine makes a round's compute scale with the sampled cohort,
but the device round still keeps every resident ``(m, width)`` client
buffer -- GPDMM's ``lam_s``/``x_c``/``u_hat``, SCAFFOLD's ``c_i``,
FedAvg's ``u_hat`` -- in device memory, and pays O(m) device work for the
server mean and the dense dual refresh.  A cohort round reads and writes
only the sampled rows (a silent client's resident state does not change),
so this module keeps the population in host numpy and stages only the
cohort:

  * ``Runner.round`` gathers the sampled rows out of the host store into a
    pinned staging slot, copies them to the device (``non_blocking``, on
    the round's stream), runs the algorithm's device body
    (``<algo>.popstore_body``: the device cohort round's per-row
    arithmetic), copies the returned rows into pinned host buffers,
    waits for that copy alone, and scatters them back into the store.
    Device memory holds O(cohort x width) and the server row.

  * The participation draw is pure in (seed, round) (``participation_key``),
    so round r+1's cohort is known during round r: its draw is enqueued
    ahead of round r's body, and while the device runs the body the host
    reads those ids and gathers the next cohort's rows into the other slot
    of a 2-slot ring.  Rows the current round updates are reconciled after
    the scatter (``np.intersect1d`` on the two id sets), and then the next
    slot's copy to the device is issued, so the next round starts without
    a host gather on its critical path.  A slot's pinned memory is written
    only after its last copy to the device has completed (an event per
    slot).

  * The O(m) server reads become O(cohort): a running ``sum(u_hat)`` is
    kept in float64 with Kahan compensation (``sum' = sum - sum(old cohort
    rows) + sum(new cohort rows)``), which tracks the dense f32 mean at f32
    resolution at any population size; the dual refresh is lazy -- lam_{s|i}
    = rho (u_hat_i - x_s) is an elementwise function of the stored uplink
    cache, so the body rebuilds exactly the staged rows it needs
    (``ops.dual_from_uplink``) and no (m, width) dual buffer exists.

State layout (a plain dict):

    {"x_s": tree (device), "round": int,
     "pop": {name: np.ndarray (m, width)}, "pop_sum": np.float64 (width,),
     "pop_sum_comp": np.float64 (width,) [, "c": tree (scaffold)]}

``Runner.round`` writes the ``pop`` arrays in place (the scatter) and
returns a new dict sharing them: callers must not hold the old state as a
snapshot.  The store holds the arena's dtype.  numpy has no bfloat16, so a
bf16 store is a CPU ``torch.bfloat16`` tensor (the reference keeps an
``ml_dtypes`` array; either checkpoints as "bfloat16") that the runner
reads and writes through a ``np.uint16`` view of its words (``_words``),
widened to f32 by a 16-bit shift for the float64 sums (``_wide``, exact).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import agpdmm, arena, fedavg, gpdmm, scaffold
from repro_torch.core import tree_util as T
from repro_torch.core.api import resolved_rho, use_cohort
from repro_torch.core.gpdmm import participation_key
from repro_torch.device import resolve
from repro_torch.telemetry import spans as _spans

_BODY_FACTORY = {
    "gpdmm": gpdmm.popstore_body,
    "agpdmm": agpdmm.popstore_body,
    "scaffold": scaffold.popstore_body,
    "fedavg": fedavg.popstore_body,
}

# Which resident (m, width) buffers each algorithm keeps in the host store,
# and which of them the server mean reads (None: the algorithm's server
# update is already O(cohort) on device -- SCAFFOLD -- and only a diagnostic
# reads the population sum).
POP_BUFFERS = {
    "gpdmm": ("u_hat", "x_c"),
    "agpdmm": ("u_hat",),
    "scaffold": ("c_i",),
    "fedavg": ("u_hat",),
}
MEAN_BUFFER = {"gpdmm": "u_hat", "agpdmm": "u_hat", "fedavg": "u_hat",
               "scaffold": None}

# Rows per chunk when (re)computing a full f64 column sum over a host
# buffer: bounds the transient f64 copy to chunk x width.
_SUM_CHUNK_ROWS = 4096

def supported(cfg: FederatedConfig) -> bool:
    return cfg.algorithm in POP_BUFFERS


def _words(t) -> np.ndarray:
    """A host view of a store buffer or pinned rows: the f32 numpy array
    itself, or the ``np.uint16`` words of a bf16 tensor (shared memory)."""
    if isinstance(t, np.ndarray):
        return t
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _wide(a: np.ndarray) -> np.ndarray:
    """Rows of the store as f32 (bf16 words shifted into the high half:
    exact); f32 rows as they are."""
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a


def _col_sum64(buf: np.ndarray) -> np.ndarray:
    """Chunked float64 column sum: O(chunk x width) transient memory."""
    out = np.zeros(buf.shape[1], np.float64)
    for i in range(0, buf.shape[0], _SUM_CHUNK_ROWS):
        out += _wide(buf[i:i + _SUM_CHUNK_ROWS]).astype(np.float64).sum(axis=0)
    return out


class _Slot:
    """One slot of the prefetch ring: pinned (on a card) host rows of every
    resident buffer and the cohort's ids, and the event after the slot's
    last copy to the device."""

    def __init__(self, buffers, mc: int, width: int, dtype, dev: torch.device):
        pin = dev.type == "cuda"
        self.rows = {n: torch.empty((mc, width), dtype=dtype, pin_memory=pin) for n in buffers}
        self.ids = torch.empty(mc, dtype=torch.int64, pin_memory=pin)
        self.copied = torch.cuda.Event() if pin else None
        self.copying = False

    def writable(self) -> None:
        """Wait until the slot's last copy to the device has completed, so
        that the host may write its pinned rows."""
        if self.copying:
            self.copied.synchronize()
            self.copying = False


class _Staged:
    """A round's cohort: its ids (host and device), its rows in a ring slot,
    and their device copies once issued."""
    __slots__ = ("round", "idx_np", "idx_dev", "slot", "dev_rows", "store_ids")

    def __init__(self, round_idx, idx_np, idx_dev, slot, store_ids):
        self.round = round_idx
        self.idx_np = idx_np
        self.idx_dev = idx_dev
        self.slot = slot
        self.dev_rows = None
        self.store_ids = store_ids

    @property
    def host_rows(self) -> dict:
        return {n: _words(t) for n, t in self.slot.rows.items()}


class Runner:
    """Host-side driver of popstore rounds.  It mirrors the ``FedOpt``
    surface (``init`` / ``round`` / ``server_params``), but ``round`` is a
    host function that holds the population in host numpy.  ``device`` is
    where the body runs (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: FederatedConfig, grad_fn, *, per_step=False, device="cuda"):
        if not supported(cfg):
            raise ValueError(
                f"popstore supports algorithms {sorted(POP_BUFFERS)}, "
                f"got {cfg.algorithm!r}")
        if cfg.algorithm == "scaffold" and cfg.uplink_bits is not None:
            scaffold.make(cfg)  # raises the canonical SCAFFOLD+EF21 error
        self.device = resolve(device)
        self.cfg = cfg
        self.grad_fn = grad_fn
        self.per_step = per_step
        self.algo = cfg.algorithm
        self.buffers = POP_BUFFERS[self.algo]
        self.mean_buffer = MEAN_BUFFER[self.algo]
        self._spec = None
        self._m = None
        self._body = None
        self._slots = None
        self._out = None
        self._next: Optional[_Staged] = None
        # prefetch-ring accounting, emitted as trace counter events when the
        # global tracer is on (docs/telemetry.md) -- a miss means the round
        # paid the host gather on its critical path
        self.ring_hits = 0
        self.ring_misses = 0

    # -- build ------------------------------------------------------------

    def _build(self, x_s, m: int):
        if self._body is not None and self._m == m:
            return
        cfg = self.cfg
        if not use_cohort(cfg, m):
            raise ValueError(
                "popstore rides the cohort engine: use_cohort(cfg, m) must "
                f"hold (participation={cfg.participation}, cohort="
                f"{cfg.cohort!r}, algorithm={cfg.algorithm!r}, m={m})")
        spec = arena.ArenaSpec.from_tree(x_s)
        dtype = spec.dtype
        self._spec, self._m = spec, m
        self._body = _BODY_FACTORY[self.algo](cfg, spec, m, self.grad_fn, self.per_step)
        mc = T.cohort_count(m, cfg.participation)
        self._slots = [_Slot(self.buffers, mc, spec.width, dtype, self.device) for _ in range(2)]
        # the round's rows come back into pinned buffers; SCAFFOLD's c row
        # with them (its c_sum_norm reads it on the host)
        pin = self.device.type == "cuda"
        self._out = {n: torch.empty((mc, spec.width), dtype=dtype, pin_memory=pin)
                     for n in self.buffers}
        if self.algo == "scaffold":
            self._out["c"] = torch.empty(spec.width, dtype=dtype, pin_memory=pin)
        self._row = torch.empty(spec.width, dtype=torch.float32, pin_memory=pin)
        self._row_copied = torch.cuda.Event() if pin else None
        self._next = None

    # -- staging / prefetch ring ------------------------------------------

    def _draw(self, round_idx: int):
        """Enqueue round ``round_idx``'s cohort draw on the device and its ids'
        copy into the round's slot; returns (ids on the device, slot, event
        after the copy or None on the CPU)."""
        slot = self._slots[round_idx % 2]
        idx_dev, _ = T.cohort_indices(participation_key(self.cfg, round_idx), self._m,
                                      self.cfg.participation, self.device)
        slot.ids.copy_(idx_dev, non_blocking=True)
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
        return idx_dev, slot, ev

    def _stage_host(self, round_idx: int, store, drawn=None) -> _Staged:
        """Round ``round_idx``'s cohort gathered from the store into its ring
        slot (``drawn``: its draw, already enqueued by ``_draw``)."""
        idx_dev, slot, ev = drawn if drawn is not None else self._draw(round_idx)
        if ev is not None:
            ev.synchronize()  # the draw and the ids' copy only
        idx_np = slot.ids.numpy().copy()
        slot.writable()
        for name in self.buffers:
            _words(slot.rows[name])[...] = _words(store[name])[idx_np]
        return _Staged(round_idx, idx_np, idx_dev, slot,
                       tuple(id(store[n]) for n in self.buffers))

    def _h2d(self, staged: _Staged) -> None:
        """Issue the slot's copies to the device on the current stream."""
        slot = staged.slot
        if slot.copied is None:  # on the CPU the body gets copies of its own
            staged.dev_rows = {n: t.clone() for n, t in slot.rows.items()}
            return
        staged.dev_rows = {n: t.to(self.device, non_blocking=True) for n, t in slot.rows.items()}
        slot.copied.record()
        slot.copying = True

    def _take_prefetch(self, round_idx: int, store) -> Optional[_Staged]:
        nxt, self._next = self._next, None
        if (nxt is not None and nxt.round == round_idx
                and nxt.store_ids == tuple(id(store[n]) for n in self.buffers)):
            return nxt
        return None  # rollback / resume / fresh state: restage from scratch

    # -- state ------------------------------------------------------------

    def init(self, params, m: int):
        params = T.tmap(lambda p: p.to(self.device), params)
        self._build(params, m)
        spec = self._spec
        row_t = spec.pack(params).cpu()
        row = _words(row_t)
        pop = {}
        for name in self.buffers:
            buf = (torch.empty((m, spec.width), dtype=row_t.dtype)
                   if row_t.dtype == torch.bfloat16 else np.empty((m, spec.width), row.dtype))
            if name == "c_i":
                _words(buf)[:] = 0  # SCAFFOLD control variates start at zero
            else:
                _words(buf)[:] = row  # u_hat / x_c: round-0 broadcast of the server row
            pop[name] = buf
        sum_name = self.mean_buffer or self.buffers[0]
        if sum_name == "c_i":
            pop_sum = np.zeros(spec.width, np.float64)
        else:
            # m identical rows: m * row is the correctly rounded f64 sum
            pop_sum = _wide(row).astype(np.float64) * m
        state = {
            "x_s": params,
            "round": 0,
            "pop": pop,
            "pop_sum": pop_sum,
            "pop_sum_comp": np.zeros(spec.width, np.float64),
        }
        if self.algo == "scaffold":
            state["c"] = T.tree_zeros_like(params)
        self._next = None
        return state

    def _normalize(self, state):
        """Repair a state handed back from elsewhere (a checkpoint's
        read-only numpy, tensors, or f32 sums): the store must be writable
        host numpy and the running sum exact f64."""
        store = state["pop"]
        changed = False
        for name, buf in store.items():
            if torch.is_tensor(buf) and buf.dtype == torch.bfloat16:
                b = buf.detach()
                if b.device.type != "cpu" or not b.is_contiguous():
                    b = b.cpu().contiguous()
                    changed = True
            else:
                b = buf.detach().cpu().numpy() if torch.is_tensor(buf) else np.asarray(buf)
                if not isinstance(buf, np.ndarray) or not b.flags.writeable:
                    b = np.array(b)
                    changed = True
            store[name] = b
        s = np.asarray(state["pop_sum"])
        comp = np.asarray(state["pop_sum_comp"])
        sum_name = self.mean_buffer or self.buffers[0]
        if s.dtype != np.float64 or comp.dtype != np.float64:
            s = _col_sum64(_words(store[sum_name]))
            comp = np.zeros_like(s)
            changed = True
        state["pop_sum"], state["pop_sum_comp"] = s, comp
        if changed:
            self._next = None  # any prefetch staged off the old arrays is dead
        return state

    # -- the round ---------------------------------------------------------

    def round(self, state, batch):
        self._build(state["x_s"], next(iter(state["pop"].values())).shape[0])
        state = self._normalize(state)
        spec, m, dev = self._spec, self._m, self.device
        r = int(state["round"])
        store = state["pop"]

        # telemetry (docs/telemetry.md): every phase below is a span on the
        # global tracer; all of it is the shared no-op singleton when
        # tracing is off, so the telemetry-off round does no added host work
        tr = _spans.get_tracer()
        staged = self._take_prefetch(r, store)
        if staged is None:
            # ring miss: the draw and the host gather land on the critical path
            self.ring_misses += 1
            with tr.span("popstore/host_gather", {"round": r}):
                staged = self._stage_host(r, store)
        else:
            self.ring_hits += 1
        if tr.enabled:
            tr.counter("popstore/ring", {"hit": self.ring_hits, "miss": self.ring_misses})
        if staged.dev_rows is None:
            with tr.span("popstore/h2d_stage", {"round": r}):
                self._h2d(staged)
        server = {"x_s": state["x_s"]}
        if self.algo == "scaffold":
            server["c"] = state["c"]
        # round r+1's draw goes onto the stream ahead of this round's body,
        # so the host reads its ids while the device runs the body
        with tr.span("popstore/prefetch_draw", {"round": r + 1}):
            drawn = self._draw(r + 1)
        with tr.span("popstore/device_round", {"round": r}):
            rows_out, server_rows, dev_metrics = self._body(
                server, staged.dev_rows, staged.idx_dev,
                torch.full((), r, dtype=torch.int32, device=dev), batch)
            fetch = dict(rows_out)
            if self.algo == "scaffold":
                fetch["c"] = server_rows["c"]
            for name, t in fetch.items():
                self._out[name].copy_(t, non_blocking=True)
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record()

        # prefetch ring: round r+1's cohort is already drawn, so gather its
        # rows now, while the device runs the body above.  Rows round r is
        # about to update are reconciled below, after the scatter.
        with tr.span("popstore/prefetch_gather", {"round": r + 1}):
            nxt = self._stage_host(r + 1, store, drawn)

        with tr.span("popstore/device_sync", {"round": r}):
            if done is not None:
                done.synchronize()  # this round's rows only
            new_rows = {n: _words(self._out[n]) for n in self.buffers}
        idx_np = staged.idx_np
        words = {n: _words(store[n]) for n in self.buffers}

        with tr.span("popstore/scatter_back", {"round": r}):
            # incremental server sum BEFORE the scatter (needs the old rows)
            sum_name = self.mean_buffer or self.buffers[0]
            # (rows added in f64 in order, as the reference's astype-then-sum)
            delta = (_wide(new_rows[sum_name]).sum(axis=0, dtype=np.float64)
                     - _wide(words[sum_name][idx_np]).sum(axis=0, dtype=np.float64))
            # Kahan-compensated accumulation: the per-round delta is tiny next
            # to the population sum at large m, exactly where naive f64 += leaks
            y = delta - state["pop_sum_comp"]
            t = state["pop_sum"] + y
            comp_new = (t - state["pop_sum"]) - y
            sum_new = t

            for name in self.buffers:
                words[name][idx_np] = new_rows[name]

            # reconcile the prefetched slot with the rows just scattered
            common, pos_next, _ = np.intersect1d(nxt.idx_np, idx_np, return_indices=True)
            if common.size:
                for name, buf in nxt.host_rows.items():
                    buf[pos_next] = words[name][common]

        new_state = {
            "round": r + 1,
            "pop": store,
            "pop_sum": sum_new,
            "pop_sum_comp": comp_new,
        }
        host_metrics = {"used_popstore": np.float32(1.0)}
        if self.algo == "scaffold":
            new_state["x_s"] = spec.unpack(server_rows["x_s"])
            new_state["c"] = spec.unpack(server_rows["c"])
            c_row64 = _wide(_words(self._out["c"])).astype(np.float64)
            host_metrics["c_sum_norm"] = np.float32(np.linalg.norm(sum_new - m * c_row64))
        else:
            # the round's single "all-reduce": the incrementally maintained
            # population sum, read at f32 resolution
            x_np = (sum_new / m).astype(np.float32)
            new_state["x_s"] = spec.unpack(self._row_to_device(x_np))
            if self.algo in ("gpdmm", "agpdmm"):
                rho = resolved_rho(self.cfg)
                # KKT invariant (25) off the lazy dual: sum_i lam_{s|i}
                # = rho (sum_i u_hat_i - m x_s)
                host_metrics["lam_sum_norm"] = np.float32(np.linalg.norm(
                    rho * (sum_new - m * x_np.astype(np.float64))))
        with tr.span("popstore/h2d_stage", {"round": r + 1, "prefetch": True}):
            self._h2d(nxt)
        self._next = nxt
        return new_state, dict(dev_metrics) | host_metrics

    def _row_to_device(self, x_np: np.ndarray) -> torch.Tensor:
        """The server row on the device, copied from a pinned buffer on the
        round's stream (the buffer is rewritten only after that copy)."""
        if self._row_copied is not None:
            self._row_copied.synchronize()
        self._row.numpy()[:] = x_np
        out = self._row.to(self.device, non_blocking=True)
        if self._row_copied is not None:
            self._row_copied.record()
        else:
            out = out.clone()  # on the CPU ``to`` returns the buffer itself
        return out

    def server_params(self, state):
        return state["x_s"]


def device_bytes(cfg: FederatedConfig, width: int, m: int) -> int:
    """Staged-state device footprint bound for one popstore round: the
    2-slot ring of cohort rows per resident buffer (the body's own
    cohort-sized temporaries are the caller's to add).  Reported next to the
    O(m x width) device-resident footprint it replaces."""
    mc = T.cohort_count(m, cfg.participation)
    n_buf = len(POP_BUFFERS[cfg.algorithm])
    return 2 * n_buf * mc * width * 4  # f32 rows (a bf16 arena stages half)
