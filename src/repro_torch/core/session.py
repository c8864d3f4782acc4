"""Streaming CacheSession: online replay with mid-stream costs and snapshots.

The port of ``repro.core.session``.  A CDN operator sees requests as they
arrive, not as a finished trace: :class:`CacheSession` takes time-ordered
request chunks of any size through :meth:`CacheSession.feed`, carries the
T_CG window (Alg. 1 Event 1) across chunk boundaries exactly as the
offline replay carries it across batches, and so reproduces the offline
costs at any chunking (1e-9 relative, integer counters exact) with the
same partition, ``E`` and anchors.

Each chunk is one device replay through the session's one
:class:`~repro_torch.core.replay.TorchReplayEngine`, continuing the open
window (``next_cg0``, ``win_prefix``): AKPC with a uniform dt takes the
device clique generation, everything else the host schedule.  The cache
state lives on the host between chunks (one upload and one download a
chunk); :class:`repro_torch.serving.LiveServingEngine` is the server that
keeps it on the card.

:meth:`CacheSession.snapshot` / :meth:`CacheSession.restore` carry the
whole replay state as a tree of numpy arrays under ``repro``'s keys,
dtypes and refusals: a snapshot of either package's session restores into
the other and resumes bit for bit.  :meth:`CacheSession.save` and
:func:`load_snapshot` persist snapshots through
:mod:`repro_torch.checkpoint`, whose on-disk format is the port's own
(one ``.npz`` a step); the packages exchange snapshots as the in-memory
dict.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time as _time

import numpy as np

from .cliques import CliquePartition
from .cost import CacheEnvironment, CostBreakdown
from .engine import DEFAULT_BATCH_SIZE, CacheState, ReplayEngine
from .policy import BasePolicy, RunResult, get_policy
from .replay import TorchReplayEngine
from .state_layout import StateLayout
from ..traces.loader import Trace


def _tag_to_array(tag: str) -> np.ndarray:
    """A string tag as a uint8 byte array (snapshots hold numerics only)."""
    return np.frombuffer(tag.encode("utf-8"), dtype=np.uint8).copy()


def _tag_from_array(a) -> str:
    return bytes(np.asarray(a, dtype=np.uint8)).decode("utf-8")


def _params_array(params) -> np.ndarray:
    """The numeric ``CostParams`` fields in declared order (``cost_mode``
    travels as a tag)."""
    return np.array([
        float(getattr(params, f.name))
        for f in dataclasses.fields(params) if f.name != "cost_mode"
    ])


def pack_partition(part: CliquePartition) -> np.ndarray:
    """(k, max|c|) int64 members, -1 padded, rows in clique order (a copy
    of :meth:`CliquePartition.packed`)."""
    return part.packed().copy()


def unpack_partition(n: int, packed: np.ndarray) -> CliquePartition:
    """The partition of a :func:`pack_partition` array."""
    cliques = [tuple(int(x) for x in row[row >= 0]) for row in np.asarray(packed)]
    clique_of = np.full(n, -1, np.int32)
    for i, c in enumerate(cliques):
        for d in c:
            clique_of[d] = i
    return CliquePartition(n=n, cliques=cliques, clique_of=clique_of)


def check_chunk(items, servers, times, last_t: float) -> tuple:
    """Validate one request chunk: ``items`` (R, d) (a 1-D row is one
    request), ``servers`` and ``times`` (R,), times non-decreasing and not
    before ``last_t``.  Returns them as int / int64 / float64 arrays."""
    items = np.atleast_2d(np.asarray(items))
    servers = np.asarray(servers, dtype=np.int64).reshape(-1)
    times = np.asarray(times, dtype=np.float64).reshape(-1)
    R = times.shape[0]
    if R and (items.shape[0] != R or servers.shape[0] != R):
        raise ValueError(
            f"chunk shape mismatch: items {items.shape}, "
            f"servers {servers.shape}, times {times.shape}")
    if R and ((np.diff(times) < 0).any() or times[0] < last_t):
        raise ValueError("requests must be fed in non-decreasing time order")
    return items, servers, times


class CacheSession:
    """Streams requests through one cache policy on ``device`` (default
    CUDA).

    ``policy`` may be a registry name or an instance; it is (re)bound to
    this session's catalog.  ``trace`` is needed only by offline policies
    (``dp_greedy`` mines its fixed pairs from it) and, as in the offline
    replay (``run_policy``), resolves a sized trace's environment.
    ``layout`` is the device state layout (dense or bucketed); the host
    state is dense under either, so a snapshot restores across them.
    """

    def __init__(self, policy: BasePolicy | str, n: int, m: int, *,
                 trace=None, batch_size: int | None = None,
                 env: CacheEnvironment | None = None, layout=None,
                 device=None):
        self.layout = StateLayout.resolve(layout)
        if isinstance(policy, str):
            policy = get_policy(policy)
        self.policy = policy
        self.n = n
        self.m = m
        policy.bind(n, m)
        if env is None:
            env = getattr(policy, "env", None)
        if trace is not None:
            # the offline replay's resolution rule (run_policy)
            env = CacheEnvironment.resolve(env, trace, policy.params)
        elif env is None:
            env = CacheEnvironment(n=n, m=m, params=policy.params)
        self.env = env
        self.engine = ReplayEngine(
            n, m, policy.params,
            caching_charge=getattr(policy, "caching_charge", "requested"),
            seed_new_cliques=getattr(policy, "seed_new_cliques", True),
            env=env,
            cost_model=getattr(policy, "cost_model", "table1"),
        )
        #: the device replay every chunk goes through
        self.replayer = TorchReplayEngine(
            engine=self.engine, device=device, layout=self.layout)
        self.device = self.replayer.device
        part0 = policy.initial_partition(trace)
        if part0 is not None:
            self.engine.install_partition(part0, now=0.0)
        self.batch_size = int(
            batch_size or getattr(policy, "batch_size", None)
            or DEFAULT_BATCH_SIZE)
        self._t_cg = policy.t_cg
        self._next_cg: float | None = None
        # the open window: (items int32, servers int32) rows since the
        # last boundary
        self._win: list[tuple[np.ndarray, np.ndarray]] = []
        self._last_t = -np.inf
        self._wall = 0.0

    # -- views -------------------------------------------------------------
    @property
    def costs(self) -> CostBreakdown:
        """Live cost breakdown (valid mid-stream)."""
        return self.engine.costs

    @property
    def partition(self) -> CliquePartition:
        """The currently installed clique partition."""
        return self.engine.state.partition

    @property
    def now(self) -> float:
        """Time of the most recently fed request (-inf before any)."""
        return self._last_t

    # -- streaming ---------------------------------------------------------
    def feed(self, items, servers, times) -> CostBreakdown:
        """Feed one time-ordered chunk of requests; returns live costs.

        ``items`` (R, d) int, -1 padded (a 1-D row is one request);
        ``servers`` (R,); ``times`` (R,) non-decreasing and not before any
        time fed earlier.  Chunk boundaries are free: the T_CG window is
        carried across them.
        """
        t0 = _time.perf_counter()
        items, servers, times = check_chunk(items, servers, times,
                                            self._last_t)
        if times.shape[0] == 0:
            return self.engine.costs
        windowed = self._t_cg is not None
        if windowed and self._next_cg is None:
            self._next_cg = float(times[0]) + self._t_cg
        self.replayer.replay(
            Trace(times=times, servers=servers, items=items, n=self.n,
                  m=self.m),
            clique_generator=self.policy.on_window if windowed else None,
            t_cg=self._t_cg,
            batch_size=self.batch_size,
            next_cg0=self._next_cg if windowed else None,
            win_prefix=(self.window_arrays()
                        if windowed and self._win else None),
        )
        if windowed:
            self.advance_window(self.replayer.last_schedule, items, servers)
        self._last_t = float(times[-1])
        self._wall += _time.perf_counter() - t0
        return self.engine.costs

    def advance_window(self, schedule, items, servers) -> None:
        """The T_CG bookkeeping after a chunk's ``schedule`` (host or
        device CGM): the next boundary, and the open window's rows."""
        if schedule.next_cg is not None:
            self._next_cg = schedule.next_cg
        if schedule.boundary_hit:
            self._win = []          # the prefix was consumed by an Event 1
        if schedule.win_start < items.shape[0]:
            self._win.append((
                np.array(items[schedule.win_start:], dtype=np.int32),
                np.array(servers[schedule.win_start:], dtype=np.int32),
            ))

    def feed_trace(self, trace, chunk_size: int | None = None
                   ) -> CostBreakdown:
        """Stream a whole trace: one replay, or :meth:`feed` calls of
        ``chunk_size`` requests.

        Refuses a sized trace when this session's size-aware model would
        price it with a size-less environment (the offline replay derives
        the environment from the trace): construct the session with
        ``trace=`` or ``env=`` instead.
        """
        if getattr(trace, "sizes", None) is not None \
                and self.engine.model.uses_sizes \
                and self.engine.env.item_sizes is None:
            raise ValueError(
                "trace carries item sizes but the session's environment has "
                "none; pass trace= or env= at construction")
        cs = int(chunk_size or max(1, trace.n_requests))
        for s in range(0, trace.n_requests, cs):
            self.feed(trace.items[s:s + cs], trace.servers[s:s + cs],
                      trace.times[s:s + cs])
        return self.engine.costs

    def window_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """The open window's requests as one padded (W, d) int32 pair."""
        if not self._win:
            return np.zeros((0, 1), np.int32), np.zeros(0, np.int32)
        d = max(a.shape[1] for a, _ in self._win)
        W = sum(a.shape[0] for a, _ in self._win)
        its = np.full((W, d), -1, np.int32)
        svs = np.empty(W, np.int32)
        r = 0
        for a, s in self._win:
            its[r:r + a.shape[0], :a.shape[1]] = a
            svs[r:r + a.shape[0]] = s
            r += a.shape[0]
        return its, svs

    # -- results -----------------------------------------------------------
    def result(self) -> RunResult:
        pol = self.policy
        return RunResult(
            policy=pol.name,
            costs=self.engine.costs,
            clique_sizes=self.partition.sizes(),
            size_history=list(pol.size_history),
            n_windows=pol.n_windows,
            cg_seconds=pol.cg_seconds,
            wall_seconds=self._wall,
            config=pol.config,
            state=self.engine.state,
        )

    # -- snapshot / restore --------------------------------------------------
    def snapshot(self) -> dict:
        """The full replay state (engine, open window, policy) as a tree of
        numpy arrays, under ``repro``'s keys and dtypes."""
        st = self.engine.state
        c = self.engine.costs
        w_it, w_sv = self.window_arrays()
        env = self.engine.env

        def arr(a):
            return np.zeros(0) if a is None else a.copy()

        return {
            "engine": {
                "E": st.E.copy(),
                "anchor": st.anchor.copy(),
                "partition": pack_partition(st.partition),
                # a restore must price under the same scenario
                "cost_model": _tag_to_array(self.engine.model.name),
                "model_config": self.engine.model.config_array(),
                "layout": _tag_to_array(self.layout.tag),
                "layout_shards": np.int64(self.layout.row_shards),
                "env": {
                    "lam_j": arr(env.lam_j),
                    "mu_j": arr(env.mu_j),
                    "item_sizes": arr(env.item_sizes),
                    "params": _params_array(env.params),
                    "cost_mode": _tag_to_array(env.params.cost_mode),
                },
                "costs": {
                    f.name: (_tag_to_array(c.model) if f.name == "model"
                             else np.asarray(getattr(c, f.name)))
                    for f in dataclasses.fields(c)
                },
            },
            "session": {
                "next_cg": np.float64(
                    np.nan if self._next_cg is None else self._next_cg),
                "last_t": np.float64(self._last_t),
                "win_items": w_it,
                "win_servers": w_sv,
                "wall": np.float64(self._wall),
            },
            "policy": self.policy.state_dict(),
        }

    def restore(self, snap: dict) -> "CacheSession":
        """Load a :meth:`snapshot` (of either package); the session resumes
        bit for bit.  Refuses a snapshot taken under another cost model,
        model configuration or environment than this session's."""
        eng = snap["engine"]
        if "cost_model" in eng:
            want = _tag_from_array(eng["cost_model"])
            have = self.engine.model.name
            if want != have:
                raise ValueError(
                    f"snapshot was taken under cost model {want!r}, session "
                    f"runs {have!r}")
        if "layout" in eng:       # pre-layout snapshots restore as dense
            self.layout.check_restore(
                _tag_from_array(eng["layout"]),
                int(np.asarray(eng.get("layout_shards", 1)).item()))
        env = self.engine.env
        snap_env = eng.get("env", {})
        if "cost_mode" in snap_env and \
                _tag_from_array(snap_env["cost_mode"]) != env.params.cost_mode:
            raise ValueError(
                f"snapshot cost_mode {_tag_from_array(snap_env['cost_mode'])!r}"
                f" != session {env.params.cost_mode!r}")
        for key, mine in (
            ("lam_j", env.lam_j), ("mu_j", env.mu_j),
            ("item_sizes", env.item_sizes),
            ("params", _params_array(env.params)),
        ):
            if key == "params" and "params" not in snap_env:
                continue
            theirs = np.asarray(snap_env.get(key, np.zeros(0)))
            mine = np.zeros(0) if mine is None else mine
            if theirs.shape != mine.shape:
                raise ValueError(
                    f"snapshot environment mismatch on {key}: shape "
                    f"{theirs.shape} vs {mine.shape}")
            if not np.array_equal(theirs, mine):
                raise ValueError(
                    f"snapshot environment mismatch on {key}: values differ "
                    f"(max abs diff {np.abs(theirs - mine).max():.3g})")
        if "model_config" in eng:
            theirs = np.asarray(eng["model_config"])
            mine = self.engine.model.config_array()
            if theirs.shape != mine.shape or not np.array_equal(theirs, mine):
                raise ValueError(
                    "snapshot was taken under a differently-configured "
                    f"{self.engine.model.name!r} model (e.g. tier schedule)")
        part = unpack_partition(self.n, eng["partition"])
        E = np.array(eng["E"], dtype=np.float64)
        anchor = np.array(eng["anchor"], dtype=np.int32)
        if E.shape != (part.k, self.m):
            raise ValueError(
                f"snapshot shape mismatch: E {E.shape} vs partition "
                f"k={part.k}, m={self.m}")
        self.engine.state = CacheState(partition=part, E=E, anchor=anchor,
                                       m=self.m)
        self.engine._set_partition_caches(part)
        c = self.engine.costs
        for f in dataclasses.fields(c):
            if f.name == "model":
                if "model" in eng["costs"]:
                    c.model = _tag_from_array(eng["costs"]["model"])
                continue
            cast = type(getattr(c, f.name))       # int or float field
            setattr(c, f.name, cast(np.asarray(eng["costs"][f.name]).item()))
        ses = snap["session"]
        nc = float(ses["next_cg"])
        self._next_cg = None if np.isnan(nc) else nc
        self._last_t = float(ses["last_t"])
        self._wall = float(ses["wall"])
        w_it = np.asarray(ses["win_items"]).astype(np.int32)
        w_sv = np.asarray(ses["win_servers"]).astype(np.int32)
        self._win = [] if w_it.shape[0] == 0 else [(w_it, w_sv)]
        self.policy.load_state_dict(snap.get("policy", {}), partition=part)
        keep_fn = getattr(self.policy, "item_keep", None)
        if keep_fn is not None:
            # the state already reflects past evictions; only the host
            # engine's mask follows the restored policy
            self.engine.set_item_keep(keep_fn())
        return self

    # -- persistence ------------------------------------------------------
    def save(self, directory: str, step: int = 0) -> str:
        """Persist :meth:`snapshot` as checkpoint ``step`` under
        ``directory`` (:mod:`repro_torch.checkpoint`: atomic, one ``.npz``
        a step); returns the step's directory."""
        from ..checkpoint import save_checkpoint

        return save_checkpoint(
            directory, step, self.snapshot(),
            meta={"policy": self.policy.name, "n": self.n, "m": self.m})


def load_snapshot(directory: str, step: int | None = None) -> dict:
    """Read a snapshot written by :meth:`CacheSession.save` (the newest
    committed step when ``step`` is None), for :meth:`CacheSession.restore`
    of a session built with the same policy and catalog."""
    from ..checkpoint import latest_step, load_checkpoint_tree

    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed snapshot under {directory}")
    tree, _ = load_checkpoint_tree(directory, step)
    return tree
