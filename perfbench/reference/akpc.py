"""The plain reference of a served AKPC deployment: policy and stream.

Frozen from ``src/repro/core/akpc.py`` (``AKPCConfig``),
``src/repro/core/policy.py`` (``AKPCPolicy.on_window``) and
``src/repro/core/session.py`` (``CacheSession.feed``) at commit 63887c5,
numpy only: Alg. 2 (window CRM over the hot items), Alg. 3/4 (adjust,
split, approximate merge) and Alg. 5/6 (the batched replay of
:mod:`.engine`), with the clique generation at every T_CG boundary on the
previous window's requests.

:class:`ReferenceStream` takes requests in any chunking and gives the
same costs and partition as one offline replay of their concatenation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .cliques import CliquePartition, generate_cliques
from .cost import CacheEnvironment, CostBreakdown, CostParams
from .crm import WindowCRM, build_window_crm
from .engine import DEFAULT_BATCH_SIZE, ReplayEngine


@dataclasses.dataclass(frozen=True)
class AKPCConfig:
    """The AKPC knobs the benchmark's configurations set."""

    params: CostParams
    t_cg: float
    top_frac: float = 0.1
    top_frac_of: str = "window"
    enable_split: bool = True
    enable_approx_merge: bool = True
    caching_charge: str = "requested"
    seed_new_cliques: bool = True


class AKPCReference:
    """Alg. 1 Event 1 on the host: a window's requests -> a partition."""

    def __init__(self, cfg: AKPCConfig, n: int):
        self.cfg = cfg
        self.n = n
        self.partition: CliquePartition | None = None
        self._prev_crm: WindowCRM | None = None
        self.n_windows = 0

    def on_window(self, items: np.ndarray) -> CliquePartition:
        cfg = self.cfg
        crm = build_window_crm(items, self.n, cfg.params.theta, cfg.top_frac,
                               top_frac_of=cfg.top_frac_of)
        omega = cfg.params.omega if cfg.enable_split else self.n
        part = generate_cliques(
            self.partition, self._prev_crm, crm, self.n, omega,
            cfg.params.gamma, enable_split=cfg.enable_split,
            enable_approx_merge=cfg.enable_approx_merge)
        self._prev_crm = crm
        self.partition = part
        self.n_windows += 1
        return part


class ReferenceStream:
    """One AKPC deployment fed as a stream (``CacheSession.feed``).

    ``dtype`` is the float type of the cache state and the cost sums:
    float64 as the configuration states, float32 for the control.
    """

    def __init__(self, cfg: AKPCConfig, env: CacheEnvironment,
                 cost_model: str, *, dtype=np.float64,
                 batch_size: int = DEFAULT_BATCH_SIZE):
        self.policy = AKPCReference(cfg, env.n)
        self.engine = ReplayEngine(
            env.n, env.m, cfg.params, caching_charge=cfg.caching_charge,
            seed_new_cliques=cfg.seed_new_cliques, env=env,
            cost_model=cost_model, dtype=dtype)
        self.batch_size = int(batch_size)
        self._t_cg = float(cfg.t_cg)
        self._next_cg: float | None = None
        self._win: list[tuple[np.ndarray, np.ndarray]] = []
        self._last_t = -np.inf

    @property
    def costs(self) -> CostBreakdown:
        return self.engine.costs

    @property
    def partition(self) -> CliquePartition:
        return self.engine.state.partition

    def feed(self, items, servers, times) -> None:
        """One time-ordered chunk: ``items`` (R, d) -1 padded."""
        items = np.atleast_2d(np.asarray(items))
        servers = np.asarray(servers, dtype=np.int64).reshape(-1)
        times = np.asarray(times, dtype=np.float64).reshape(-1)
        R = times.shape[0]
        if R == 0:
            return
        if (np.diff(times) < 0).any() or times[0] < self._last_t:
            raise ValueError("requests must come in non-decreasing time order")
        if self._next_cg is None:
            self._next_cg = float(times[0]) + self._t_cg
        pos = 0
        while pos < R:
            cut = int(np.searchsorted(times, self._next_cg, side="left"))
            if cut <= pos:
                # the request at ``pos`` crosses a T_CG boundary: Event 1
                t = float(times[pos])
                self._regenerate(t)
                while self._next_cg <= t:
                    self._next_cg += self._t_cg
                continue
            stop = min(pos + self.batch_size, cut)
            self.engine.handle_batch(items[pos:stop], servers[pos:stop],
                                     times[pos:stop])
            self._win.append((
                np.array(items[pos:stop], dtype=np.int32, copy=True),
                np.array(servers[pos:stop], dtype=np.int32, copy=True)))
            pos = stop
        self._last_t = float(times[-1])

    def _regenerate(self, t: float) -> None:
        d = max(a.shape[1] for a, _ in self._win) if self._win else 1
        W = sum(a.shape[0] for a, _ in self._win)
        its = np.full((W, d), -1, np.int32)
        svs = np.empty(W, np.int32)
        r = 0
        for a, s in self._win:
            its[r:r + a.shape[0], :a.shape[1]] = a
            svs[r:r + a.shape[0]] = s
            r += a.shape[0]
        part = self.policy.on_window(its)
        self.engine.install_partition(part, t, its, svs)
        self._win = []
