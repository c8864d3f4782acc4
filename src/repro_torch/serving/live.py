"""Persistent serving engine on the card: the port of ``repro.serving.live``.

:class:`~repro_torch.core.session.CacheSession` is replay machinery: each
chunk uploads the cache state, replays and downloads it again.
:class:`LiveServingEngine` is the serving counterpart, a session whose
cache state stays on the card between chunks:

* **A resident carry, updated in place.**  The expiry matrix ``E``, the
  anchors and the six-slot cost accumulator go up once and are updated in
  place by every chunk (the device clique generation's carry dict too);
  no chunk uploads or downloads ``E``.  The accumulator is seeded with the
  session's absolute totals, so a :attr:`LiveServingEngine.costs` read is
  a six-float download, and a resume is exact (float64 totals travel
  through snapshots unrounded).
* **Fixed chunk shapes.**  The first chunk fixes the padded step-tensor
  dims with ``headroom``; later chunks pad into them, and a chunk that
  outgrows them ratchets the dims (counted in ``compiles``).
* **A chunk ring on CUDA events.**  Dispatch does not wait for the card:
  the host builds chunk k+1's schedule (window walk, clique generation,
  lookups) while the card runs chunk k.  Each chunk's tensors go up from
  the pinned buffers of one of ``ring`` slots with ``non_blocking=True``,
  and an event recorded after the chunk's scan guards them: a slot is
  refilled only after its event completes (a buffer refilled before its
  copy landed would corrupt a chunk silently), so a submit beyond
  ``ring`` chunks in flight waits on the oldest.  The host schedule's own
  device work (its item -> clique lookups and host clique generation) runs
  on a stream of its own, so its waits do not wait for the scans.

Two dispatch paths, as in the reference:

* the host schedule (every policy but AKPC at a uniform dt):
  :func:`~repro_torch.core.replay.build_host_schedule`, padded to the
  engine's dims, then :func:`~repro_torch.core.replay.run_schedule` on the
  resident ``E`` / anchor / accumulator; it syncs nowhere but at the
  ring's waits, at cost and state reads and in the schedule's lookups and
  host clique generation (on their own stream);
* the device clique generation (``cgm="auto"`` for an AKPC policy that
  :func:`~repro_torch.core.cgm_schedule.wants_device_cgm` admits,
  ``"force"`` to insist, ``"off"`` never):
  :func:`~repro_torch.core.cgm_schedule.build_cgm_schedule`, then
  :func:`~repro_torch.core.cgm.run_cgm_schedule` on the persistent carry;
  its adjust and merge loops read their predicates on the host, so this
  path overlaps less (``loop_stats`` counts its syncs by kind).

:meth:`LiveServingEngine.drain` flushes the buffered remainder, waits for
the ring and syncs the wrapped session, which then equals a session that
replayed the same requests itself; :meth:`LiveServingEngine.snapshot` /
:meth:`LiveServingEngine.restore` compose with the session's snapshots in
both directions (a live snapshot taken mid-stream carries the requests
not yet dispatched under ``"live"``).

The carry of the host-schedule path takes the session's state layout
(dense, bucketed or row_sharded; the ratchet's install dims grow with its
rows; on a mesh a row-sharded carry is a
:class:`~repro_torch.core.sharded_state.RowShardedState` whose blocks stay
on the mesh's ``state_row`` devices); the device CGM's carry is dense-n
under a single-shard layout, and a row-sharded one turns the device CGM
off (``cgm="force"`` raises).  ``device=None`` means CUDA (a row-sharded
layout on a mesh: the mesh's first device), which must be present;
``device="cpu"`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import contextlib
import time as _time
from collections import deque

import numpy as np
import torch

from ..core.cgm import cgm_loop_statics, init_cgm_carry, run_cgm_schedule
from ..core.cgm_schedule import (
    MAX_DEVICE_CGM_HOT,
    build_cgm_schedule,
    cgm_spec,
    pad_cgm_schedule,
    partition_from_of,
    policy_hot_dims,
    wants_device_cgm,
)
from ..core.cost import CostBreakdown
from ..core.crm import WindowCRM
from ..core.engine import CacheState
from ..core.policy import RunResult
from ..core.replay import (
    _bucket,
    build_host_schedule,
    lane_spec_to_device,
    run_schedule,
    spec_to_device,
    state_head,
    state_to_device,
)
from ..core.schedule import pad_schedule, schedule_dims
from ..core.session import CacheSession, check_chunk
from ..kernels.packed_lookup import CliqueLookup
from ..spans import span
from ..traces.loader import Trace

CGM_MODES = ("auto", "force", "off")


class ServeFuture:
    """Handle of one :meth:`LiveServingEngine.submit` call.

    :meth:`result` makes sure every request of that call has been priced
    (dispatching the buffered remainder if needed) and returns the synced
    costs.  A :meth:`LiveServingEngine.restore` invalidates it.
    """

    __slots__ = ("_eng", "_upto")

    def __init__(self, eng: "LiveServingEngine", upto: int):
        self._eng = eng
        self._upto = upto

    def done(self) -> bool:
        """True once every request of this submit has run on the card."""
        e = self._eng
        return e._dispatched_total >= self._upto and e.in_flight == 0

    def result(self) -> CostBreakdown:
        e = self._eng
        if e._dispatched_total < self._upto:
            e._flush()
        return e._sync_costs()


class _RingSlot:
    """One slot of the chunk ring: pinned host buffers for one chunk's
    tensors, by key, and the event recorded after that chunk's scan."""

    __slots__ = ("bufs", "event")

    def __init__(self):
        self.bufs: dict = {}
        self.event = None


class LiveServingEngine:
    """A streaming session whose cache state stays on the card.

    Parameters
    ----------
    policy, n, m, env, batch_size, layout, device : as for
        :class:`~repro_torch.core.session.CacheSession` (``layout``:
        dense, bucketed or row_sharded).
    chunk_size : requests a dispatched chunk; submissions buffer until a
        chunk fills, and :meth:`drain` dispatches the ragged remainder.
    ring : chunks in flight before a submit waits on the oldest.
    headroom : factor on the first chunk's step-tensor dims when fixing
        the padded shape.
    cgm : ``"auto"``, ``"force"`` or ``"off"`` (module docstring).
    use_kernels : False runs the kernels' plain versions on the same
        device (the comparison run).
    """

    def __init__(self, policy, n, m, *, env=None, batch_size=None,
                 chunk_size=32768, ring=4, headroom=2.0, cgm="auto",
                 layout=None, device=None, use_kernels: bool = True):
        if cgm not in CGM_MODES:
            raise ValueError(f"unknown cgm mode {cgm!r}; choose from "
                             f"{CGM_MODES}")
        self.session = CacheSession(policy, n, m, env=env,
                                    batch_size=batch_size, layout=layout,
                                    device=device)
        self.device = self.session.device
        self.layout = self.session.layout
        self.policy = self.session.policy
        self.n, self.m = n, m
        self.chunk_size = max(1, int(chunk_size))
        self.ring = max(1, int(ring))
        self.headroom = float(headroom)
        self.use_kernels = use_kernels
        eng = self.session.engine
        self._spec = self.session.replayer._spec
        self._statics = self.session.replayer._statics
        self._cuda = self.device.type == "cuda"
        #: the host schedule's item -> clique lookup, on its own stream
        self._lookup = CliqueLookup(self.device, use_kernels)
        self._build_stream = (torch.cuda.Stream(self.device) if self._cuda
                              else None)
        self._slots = [_RingSlot() for _ in range(self.ring)]
        self._slot = 0
        self._inflight: deque = deque()
        self._part = self.session.partition
        #: shape ratchets of the padded chunk tensors (the reference counts
        #: its XLA compiles here; the port compiles nothing per shape)
        self.compiles = 0
        #: chunks dispatched, submits that waited on the ring, device
        #: reads of the costs and of the state
        self.chunks = 0
        self.ring_waits = 0
        self.cost_reads = 0
        self.state_reads = 0
        #: the dispatches' counts and seconds, summed over chunks: the host
        #: schedule's build and lookups, the device CGM's syncs by kind, the
        #: seconds submits waited on the ring (``ring_wait_s``), the host
        #: CGM's windows whose incidence was built on the device and the
        #: bytes of ids uploaded for them (``crm_id_windows`` /
        #: ``crm_id_bytes``; 0 under the device CGM, which calls no hook);
        #: and, not summed, the device CGM's hot capacity: the one its
        #: boundaries run at (``cgm_h``) and the largest a chunk's schedule
        #: asked for (``cgm_h_need``)
        self.loop_stats: dict = {"crm_id_windows": 0, "crm_id_bytes": 0}
        self._cgm = False
        if cgm != "off":
            eligible = wants_device_cgm(
                self.policy,
                Trace(times=np.zeros(0), servers=np.zeros(0, np.int64),
                      items=np.zeros((0, 1), np.int64), n=n, m=m),
                eng.model) and self.layout.supports_device_cgm(n, m)
            if cgm == "force" and not eligible:
                raise ValueError(
                    "cgm='force': the device clique generation does not "
                    "admit this policy and cost model")
            self._cgm = eligible
        self._reset()

    def _reset(self) -> None:
        """Drop the device carry and the buffers (construction, restore)."""
        self._E = self._anchor = self._acc = None
        self._spec_d = None
        self._dims: dict | None = None
        self._cgm_carry: dict | None = None
        self._cgm_dims: dict | None = None
        self._ofs: list = []        # (boundary steps, device slot maps)
        self._cgm_bound = False     # a boundary since the carry was built
        self._acc_dirty = False
        self._pend: list = []       # (items, servers, times) buffered
        self._pend_n = 0
        self._submitted_total = 0
        self._dispatched_total = 0
        self._last_sub = self.session._last_t
        self._base_req = (0, 0)
        self._host_nreq = 0
        self._host_nitem = 0

    # -- views -------------------------------------------------------------
    @property
    def partition(self):
        """The partition after the last dispatched window boundary."""
        return self._part

    @property
    def now(self) -> float:
        """Time of the most recently submitted request (-inf before any)."""
        return max(self._last_sub, self.session._last_t)

    @property
    def in_flight(self) -> int:
        """Dispatched chunks whose event has not completed."""
        while self._inflight and self._inflight[0].query():
            self._inflight.popleft()
        return len(self._inflight)

    @property
    def pending(self) -> int:
        """Buffered requests not yet dispatched (less than one chunk)."""
        return self._pend_n

    @property
    def costs(self) -> CostBreakdown:
        """Costs of every dispatched chunk (waits for the ring; the
        buffered remainder is priced at :meth:`drain`)."""
        return self._sync_costs()

    # -- streaming ---------------------------------------------------------
    def submit(self, items, servers, times) -> ServeFuture:
        """Enqueue one time-ordered request chunk; returns a future.

        Arguments as for ``CacheSession.feed``.  Full ``chunk_size``
        chunks dispatch at once without waiting for the card; the call
        waits only when ``ring`` chunks are already in flight.
        """
        t0 = _time.perf_counter()
        items, servers, times = check_chunk(items, servers, times,
                                            self._last_sub)
        R = times.shape[0]
        if R == 0:
            return ServeFuture(self, self._submitted_total)
        self._last_sub = float(times[-1])
        self._pend.append((items, servers, times))
        self._pend_n += R
        self._submitted_total += R
        while self._pend_n >= self.chunk_size:
            self._dispatch(*self._pop_chunk(self.chunk_size))
        self.session._wall += _time.perf_counter() - t0
        return ServeFuture(self, self._submitted_total)

    def feed(self, items, servers, times) -> CostBreakdown:
        """``CacheSession.feed``-compatible :meth:`submit`; returns the
        session's breakdown without waiting for the card (read
        :attr:`costs` or call :meth:`drain` for settled numbers)."""
        self.submit(items, servers, times)
        return self.session.engine.costs

    def drain(self) -> CostBreakdown:
        """Dispatch the buffered remainder, wait for the ring and sync the
        state and costs into the wrapped session."""
        t0 = _time.perf_counter()
        self._flush()
        self._sync_state()
        self.session._wall += _time.perf_counter() - t0
        return self.session.engine.costs

    # -- snapshot / restore ------------------------------------------------
    def snapshot(self) -> dict:
        """The session's snapshot after syncing every dispatched chunk, plus
        the buffered requests under ``"live"`` (so a resume stays chunk
        aligned).  :meth:`drain` first for a snapshot without them."""
        self._sync_state()
        snap = self.session.snapshot()
        items, servers, times = self._pend_concat()
        snap["live"] = {
            "pend_items": items.astype(np.int64),
            "pend_servers": servers.astype(np.int64),
            "pend_times": times.astype(np.float64),
        }
        return snap

    def restore(self, snap: dict) -> "LiveServingEngine":
        """Load a snapshot of a live engine or of a session (of either
        package); resumes bit for bit.  Earlier futures are invalid."""
        self._block()
        self.session.restore(snap)
        self._part = self.session.partition
        self._reset()
        live = snap.get("live")
        if live is not None and np.asarray(live["pend_times"]).shape[0]:
            times = np.asarray(live["pend_times"], np.float64)
            self._pend = [(np.asarray(live["pend_items"]),
                           np.asarray(live["pend_servers"], np.int64), times)]
            self._pend_n = self._submitted_total = int(times.shape[0])
            self._last_sub = float(times[-1])
        return self

    def result(self) -> RunResult:
        """Drain and return the run's summary (``CacheSession.result``)."""
        self.drain()
        return self.session.result()

    # -- the request buffer ------------------------------------------------
    def _pop_chunk(self, k: int):
        """Take exactly ``k`` requests off the buffer."""
        out_i, out_s, out_t = [], [], []
        need = k
        while need:
            it, sv, tm = self._pend[0]
            take = min(need, tm.shape[0])
            out_i.append(it[:take])
            out_s.append(sv[:take])
            out_t.append(tm[:take])
            if take == tm.shape[0]:
                self._pend.pop(0)
            else:
                self._pend[0] = (it[take:], sv[take:], tm[take:])
            need -= take
        self._pend_n -= k
        return (_cat_items(out_i), np.concatenate(out_s),
                np.concatenate(out_t))

    def _pend_concat(self):
        """The buffer as one array triple, left in place."""
        if not self._pend:
            return (np.zeros((0, 1), np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float64))
        return (_cat_items([p[0] for p in self._pend]),
                np.concatenate([p[1] for p in self._pend]),
                np.concatenate([p[2] for p in self._pend]))

    def _flush(self) -> None:
        if self._pend_n:
            self._dispatch(*self._pop_chunk(self._pend_n))

    # -- device transfers ---------------------------------------------------
    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the device: through pinned memory without a
        wait on CUDA (the host allocator keeps the pinned block until the
        copy is done), a private copy on the CPU."""
        if not self._cuda:
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, arrays: dict) -> tuple[dict, _RingSlot | None]:
        """One chunk's host arrays on the device (int32 as int64), through
        the next ring slot's pinned buffers.  The slot is refilled only
        after the event of its previous chunk has completed; the seconds
        waited for it are summed in ``loop_stats["ring_wait_s"]``."""
        with span("live.stage"):
            if not self._cuda:
                return {k: torch.from_numpy(np.ascontiguousarray(
                    a, np.int64 if a.dtype == np.int32 else a.dtype))
                    for k, a in arrays.items()}, None
            slot = self._slots[self._slot]
            self._slot = (self._slot + 1) % self.ring
            waited = 0.0
            if slot.event is not None and not slot.event.query():
                t0 = _time.perf_counter()
                with span("live.ring_wait"):
                    slot.event.synchronize()
                waited = _time.perf_counter() - t0
                self.ring_waits += 1
            self.loop_stats["ring_wait_s"] = (
                self.loop_stats.get("ring_wait_s", 0.0) + waited)
            out = {}
            for key, a in arrays.items():
                want = np.int64 if a.dtype == np.int32 else a.dtype
                dtype = torch.from_numpy(np.zeros(0, want)).dtype
                buf = slot.bufs.get(key)
                if buf is None or buf.dtype != dtype or buf.numel() < a.size:
                    buf = torch.empty(max(1, a.size), dtype=dtype,
                                      pin_memory=True)
                    slot.bufs[key] = buf
                host = buf[:a.size]
                host.numpy()[:] = a.reshape(-1)
                out[key] = host.view(a.shape).to(self.device,
                                                 non_blocking=True)
            return out, slot

    def _finish_chunk(self, slot: _RingSlot | None, stats: dict) -> None:
        """Record the chunk's event in its slot and on the ring."""
        self.chunks += 1
        self._acc_dirty = True
        for key, v in stats.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.loop_stats[key] = self.loop_stats.get(key, 0) + v
        if slot is not None:
            ev = torch.cuda.Event()
            ev.record()
            slot.event = ev
            self._inflight.append(ev)

    def _block(self) -> None:
        """Wait for every chunk in flight."""
        while self._inflight:
            self._inflight.popleft().synchronize()

    def _build_context(self):
        return (torch.cuda.stream(self._build_stream) if self._cuda
                else contextlib.nullcontext())

    # -- the host-schedule dispatch ---------------------------------------
    def _seed(self) -> np.ndarray:
        """The accumulator's seed: the session's absolute totals."""
        c = self.session.engine.costs
        self._base_req = (c.n_requests, c.n_item_requests)
        self._host_nreq = self._host_nitem = 0
        return np.array([c.transfer, c.caching, c.keepalive_rent,
                         float(c.n_misses), float(c.n_hits),
                         float(c.items_transferred)], np.float64)

    def _ensure_carry(self) -> None:
        if self._E is not None:
            return
        eng = self.session.engine
        if self.layout.places_rows:
            # row blocks go straight to their mesh devices
            self._E, self._anchor = state_to_device(
                eng.state, self.n, self.device, self.layout)
        else:
            E0, a0 = state_to_device(eng.state, self.n, "cpu", self.layout)
            self._E = self._upload(E0)
            self._anchor = self._upload(a0)
        self._acc = self._upload(torch.from_numpy(self._seed()))
        spec = self.session.replayer._state_spec
        self._spec_d = {k: self._upload(v) for k, v in
                        lane_spec_to_device(spec, "cpu", False).items()}

    def _fix_dims(self, dims: dict) -> None:
        """Fix (or ratchet) the padded chunk shape with headroom."""
        h = self.headroom
        scale = max(1, self.layout.state_rows(self.n) // 1024)
        grown = {
            "nb": _bucket(int(dims["nb"] * 2), 4, 4),
            "ne": _bucket(int(dims["ne"] * h), 1024, 1024),
            "nu": _bucket(int(dims["nu"] * h), 512, 512),
            "na": _bucket(int(dims["na"] * h), 256, 256),
            "ncr": _bucket(int(dims["ncr"] * 2), 32 * scale, 32),
            "nci": _bucket(int(dims["nci"] * 2), 64 * scale, 64),
            "nmv": _bucket(int(dims["nmv"] * 2), 32 * scale, 32),
        }
        self._dims = (grown if self._dims is None else
                      {k: max(self._dims[k], grown[k]) for k in grown})
        self.compiles += 1

    def _dispatch(self, items, servers, times) -> None:
        """Build one chunk's schedule and launch it on the ring: the span
        ``live.dispatch``, in which the chunk's ``live.build`` and
        ``live.stage`` nest."""
        with span("live.dispatch"):
            if self._cgm:
                self._dispatch_cgm(items, servers, times)
            else:
                self._dispatch_host(items, servers, times)

    def _dispatch_host(self, items, servers, times) -> None:
        """A chunk through the host schedule, then one scan."""
        self._ensure_carry()
        sess = self.session
        eng = sess.engine
        windowed = sess._t_cg is not None
        if windowed and sess._next_cg is None:
            sess._next_cg = float(times[0]) + sess._t_cg
        with span("live.build"):
            with self._build_context():
                sched, stats = build_host_schedule(
                    self._part, Trace(times=times, servers=servers,
                                      items=items, n=self.n, m=self.m),
                    sess.policy.on_window if windowed else None, sess._t_cg,
                    model=eng.model, env=eng.env, lookup=self._lookup,
                    seed_new_cliques=eng.seed_new_cliques,
                    layout=self.layout, use_kernels=self.use_kernels,
                    next_cg0=sess._next_cg if windowed else None,
                    win_prefix=(sess.window_arrays()
                                if windowed and sess._win else None))
            if windowed:
                sess.advance_window(sched, items, servers)
            sess._last_t = float(times[-1])
            self._part = sched.final_partition
            self._host_nreq += sched.n_requests
            self._host_nitem += sched.n_item_requests
            self._dispatched_total += times.shape[0]
            dims = schedule_dims(sched)
            if self._dims is None or any(dims[k] > self._dims[k]
                                         for k in dims):
                self._fix_dims(dims)
            sched = pad_schedule(sched, self._dims)
        xs, slot = self._stage(sched.xs)
        t0 = _time.perf_counter()
        run_schedule(sched, self._spec_d, self._statics, self._E,
                     self._anchor, charge=eng.caching_charge,
                     use_kernels=self.use_kernels, stats=stats, xs=xs,
                     acc=self._acc)
        stats["scan_s"] = _time.perf_counter() - t0
        self._finish_chunk(slot, stats)

    # -- the device-CGM dispatch ------------------------------------------
    def _ensure_cgm_carry(self, sched) -> None:
        """Build the carry (once) from the session's state and open window
        at the compact dims of ``sched``."""
        if self._cgm_carry is not None:
            return
        sess = self.session
        eng = sess.engine
        pol = self.policy
        uses_sizes = bool(eng.model.uses_sizes)
        item_sizes = eng.env.sizes() if uses_sizes else None
        carry = init_cgm_carry(
            eng.state, getattr(pol, "_prev_crm", None),
            sess.window_arrays() if sess._win else None, schedule=sched,
            uses_sizes=uses_sizes, item_sizes=item_sizes, device="cpu")
        cfg = pol.config
        self._cspec = cgm_spec(cfg, cfg.params, self.n)
        self._cgm_statics = cgm_loop_statics(
            self._cspec, carry, enable_acm=cfg.enable_approx_merge)
        carry["acc"] = torch.from_numpy(self._seed())
        self._cgm_carry = {k: (self._upload(v) if isinstance(v, torch.Tensor)
                               else v) for k, v in carry.items()}
        self._spec_d = {k: (self._upload(v) if isinstance(v, torch.Tensor)
                            else v)
                        for k, v in spec_to_device(self._spec, "cpu").items()}
        self._sz_d = (None if item_sizes is None else self._upload(
            torch.as_tensor(item_sizes, dtype=torch.float64)))
        self._cgm_bound = False

    def _grow_cgm_carry(self, h: int, wcap: int, dbuf: int) -> None:
        """Re-embed the carry in a larger compact workspace, on the device
        (the stream orders it after the chunks in flight)."""
        c = self._cgm_carry
        oh = int(c["p_idx"].shape[0])
        ow, od = (int(x) for x in c["wbuf"].shape)
        h, wcap, dbuf = max(h, oh), max(wcap, ow), max(dbuf, od)
        dev = c["p_idx"].device
        if h > oh:
            p_idx = torch.full((h,), self.n, dtype=torch.int64, device=dev)
            p_idx[:oh] = c["p_idx"]
            c["p_idx"] = p_idx
            for key in ("praw", "pnorm", "pbin"):
                a = torch.zeros((h, h), dtype=c[key].dtype, device=dev)
                a[:oh, :oh] = c[key]
                c[key] = a
        if wcap > ow or dbuf > od:
            wbuf = torch.full((wcap, dbuf), -1, dtype=torch.int64, device=dev)
            wbuf[:ow, :od] = c["wbuf"]
            c["wbuf"] = wbuf

    def _dispatch_cgm(self, items, servers, times) -> None:
        """A chunk of raw requests; the clique generation runs on the
        card inside the replay."""
        sess = self.session
        eng = sess.engine
        with span("live.build"):
            if sess._next_cg is None:
                sess._next_cg = float(times[0]) + sess._t_cg
            # the open window's rows are already in the carry's buffer; the
            # schedule's head window must count them
            pre_rows = pre_slots = pre_d = 0
            for w_it, _ in sess._win:
                pre_rows += int(w_it.shape[0])
                pre_slots += int(w_it.size)
                pre_d = max(pre_d, int(w_it.shape[1]))
            sched = build_cgm_schedule(
                Trace(times=times, servers=servers, items=items, n=self.n,
                      m=self.m), sess._t_cg,
                uses_sizes=bool(eng.model.uses_sizes), next_cg0=sess._next_cg,
                hot_dims=policy_hot_dims(self.policy), prefix_rows=pre_rows,
                prefix_slots=pre_slots)
            if sched.h > MAX_DEVICE_CGM_HOT:
                raise ValueError(
                    f"device CGM: a chunk's hot capacity h={sched.h} passes "
                    f"MAX_DEVICE_CGM_HOT={MAX_DEVICE_CGM_HOT}; serve this "
                    "stream with cgm='off'")
            dims = {"nb": sched.nb, "B": sched.B, "d": max(sched.d, pre_d),
                    "h": sched.h, "W": sched.wcap}
            if self._cgm_dims is None or any(
                    dims[k] > self._cgm_dims[k] for k in dims):
                grown = {"nb": _bucket(dims["nb"] * 2, 4, 4),
                         "B": _bucket(dims["B"] * 2, 32, 32),
                         "d": dims["d"],
                         "h": min(self.n, MAX_DEVICE_CGM_HOT,
                                  _bucket(dims["h"] * 2, 32, 32)),
                         "W": _bucket(dims["W"] * 2, 64, 64)}
                self._cgm_dims = (grown if self._cgm_dims is None else
                                  {k: max(self._cgm_dims[k], grown[k])
                                   for k in grown})
                self.compiles += 1
            sched = pad_cgm_schedule(sched, self._cgm_dims)
            # a larger B re-derives wcap: fold it back into the dims
            self._cgm_dims["W"] = max(self._cgm_dims["W"], sched.wcap)
            # the carry is built from the open window BEFORE this chunk
            self._ensure_cgm_carry(sched)
            c = self._cgm_carry
            ch = int(c["p_idx"].shape[0])
            cw, cd = (int(x) for x in c["wbuf"].shape)
            if ch < sched.h or cw < sched.wcap or cd < sched.d:
                self._grow_cgm_carry(sched.h, sched.wcap, sched.d)
            elif ch > sched.h:
                # a restored previous-window CRM made the carry's h larger
                self._cgm_dims["h"] = max(self._cgm_dims["h"], ch)
            self.loop_stats["cgm_h"] = self._cgm_dims["h"]
            self.loop_stats["cgm_h_need"] = max(
                self.loop_stats.get("cgm_h_need", 0), dims["h"])
            sess.advance_window(sched, items, servers)
        if sched.boundary_hit:
            self._cgm_bound = True
        sess._last_t = float(times[-1])
        self._host_nreq += sched.n_requests
        self._host_nitem += sched.n_item_requests
        self._dispatched_total += times.shape[0]
        xs, slot = self._stage({k: sched.xs[k]
                                for k in ("items", "servers", "times")})
        cfg = self.policy.config
        t0 = _time.perf_counter()
        self._cgm_carry, ofs, stats = run_cgm_schedule(
            sched, self._spec_d, self._statics, self._cspec,
            self._cgm_carry, self._sz_d, charge=eng.caching_charge,
            enable_split=cfg.enable_split,
            enable_acm=cfg.enable_approx_merge,
            seed_new=eng.seed_new_cliques, use_kernels=self.use_kernels,
            requests=(xs["items"], xs["servers"], xs["times"]),
            loop_statics=self._cgm_statics)
        stats["scan_s"] = _time.perf_counter() - t0
        self._ofs.append((sched.boundary_steps, ofs))
        self._finish_chunk(slot, stats)

    # -- syncs back to the session ------------------------------------------
    def _sync_costs(self) -> CostBreakdown:
        """Assign the device accumulator into the session's breakdown."""
        self._block()
        c = self.session.engine.costs
        acc_dev = self._cgm_carry["acc"] if self._cgm_carry else self._acc
        if acc_dev is not None and self._acc_dirty:
            acc = acc_dev.cpu().numpy()
            self.cost_reads += 1
            c.transfer = float(acc[0])
            c.caching = float(acc[1])
            c.keepalive_rent = float(acc[2])
            c.n_misses = int(acc[3])
            c.n_hits = int(acc[4])
            c.items_transferred = int(acc[5])
            c.n_requests = self._base_req[0] + self._host_nreq
            c.n_item_requests = self._base_req[1] + self._host_nitem
            self._acc_dirty = False
        return c

    def _sync_state(self) -> None:
        """Download the carry into the session (costs and cache state)."""
        self._sync_costs()
        if self._cgm:
            self._sync_state_cgm()
            return
        if self._E is None:
            return
        eng = self.session.engine
        k = self._part.k
        self.state_reads += 1
        eng.state = CacheState.from_device(
            self._part, state_head(self._E, k, False),
            state_head(self._anchor, k, False), self.m)
        eng._set_partition_caches(self._part)
        keep_fn = getattr(self.policy, "item_keep", None)
        if keep_fn is not None:
            # the evictions ran on the device; align the host engine's mask
            eng.set_item_keep(keep_fn())

    def _sync_state_cgm(self) -> None:
        """The device-CGM carry into the session and the policy's window
        bookkeeping (``sync_policy_from_run`` over the chunks since the
        last sync)."""
        c = self._cgm_carry
        if c is None:
            return
        eng = self.session.engine
        pol = self.policy
        part = self._part
        self.state_reads += 1
        if self._cgm_bound:
            part = partition_from_of(self.n, c["of"].cpu().numpy())
        eng.state = CacheState.from_device(
            part, c["E"][:part.k].cpu().numpy(),
            c["anchor"][:part.k].cpu().numpy(), self.m)
        eng._set_partition_caches(part)
        nbd = 0
        for bsteps, ofs in self._ofs:
            if bsteps.size:
                ofs_np = ofs.cpu().numpy()
                for i in range(bsteps.size):
                    sizes = np.bincount(ofs_np[i]).astype(np.int64)
                    pol.size_history.append(sizes[sizes > 1])
                nbd += int(bsteps.size)
        self._ofs = []
        pol.n_windows += nbd
        if self._cgm_bound:
            pol._partition = part
            pol._prev_crm = WindowCRM.from_compact(
                c["p_idx"].cpu().numpy(), c["praw"].cpu().numpy(),
                c["pnorm"].cpu().numpy(), c["pbin"].cpu().numpy(), n=self.n)
        self._part = part


def _cat_items(chunks: list) -> np.ndarray:
    """Concatenate (R_i, d_i) item arrays, -1 padding to the widest d."""
    if len(chunks) == 1:
        return chunks[0]
    d = max(a.shape[1] for a in chunks)
    R = sum(a.shape[0] for a in chunks)
    out = np.full((R, d), -1, dtype=np.int64)
    r = 0
    for a in chunks:
        out[r:r + a.shape[0], :a.shape[1]] = a
        r += a.shape[0]
    return out
