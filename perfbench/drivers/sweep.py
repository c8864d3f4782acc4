"""An operator's pricing sweep: the grid of the mix over a pool of traces.

Set-up makes the pool (its traces from seeds derived from the run's
seed) and warms the cell's own path with one whole sweep of the grid
over the first trace.  The window runs whole sweeps, each a fresh
``SweepEngine`` over the next trace of the pool, until ``--seconds``
have passed; the rate is points x requests of every sweep completed
over the time from the window's start to the end of the last sweep.

The check replays a sample of the swept points through the plain
reference (each point's whole trace) and compares their costs and final
partitions: a point of every rho, and the grid's first and last points
(:meth:`Driver.sample`).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from .. import check, inputs
from . import Base
from ..reference.akpc import AKPCConfig, ReferenceStream
from ..reference import cost as ref_cost
from ..tracing import span


class Driver(Base):

    def _grid(self, req) -> list:
        """The grid over one trace: (pricing params, T_CG) a point."""
        span_t = float(req.times[-1] - req.times[0])
        out = []
        base = dict(self.cfg["params"])
        for rho in inputs.grid(self.mix["rhos"]):
            for alpha in inputs.grid(self.mix["alphas"]):
                p = {**base, "alpha": float(alpha), "rho": float(rho)}
                out.append((p, inputs.t_cg_for(
                    span_t, inputs.max_dt(p, None, None))))
        return out

    def _program_points(self, req, grid) -> list:
        """The program's ``SweepPoint`` list of a grid over one trace."""
        from repro_torch.core import CostParams, SweepPoint
        from repro_torch.traces.loader import Trace

        tr = Trace(times=req.times, servers=req.servers, items=req.items,
                   n=req.n, m=req.m, sizes=req.sizes)
        return [SweepPoint(self.cfg["policy_name"], tr,
                           dict(params=CostParams(**p), t_cg=t_cg,
                                **self.policy))
                for p, t_cg in grid]

    def make_inputs(self) -> None:
        """The pool and each trace's grid (no program)."""
        cfg, mix = self.cfg, self.mix
        self.policy = {k: v for k, v in {
            **cfg["policy"], **self.cell["workload"].get("policy", {})
        }.items() if k != "t_cg_span"}
        self.pool = [inputs.requests(cfg["generator"], mix["requests"],
                                     inputs.derived_seed(self.seed, 1, i))
                     for i in range(int(mix["pool"]))]
        self.grids = [self._grid(r) for r in self.pool]

    def served(self, sweeps: int) -> None:
        """Set the window's extent to ``sweeps`` whole sweeps."""
        self.results = [(i % len(self.pool), None) for i in range(sweeps)]

    def setup(self) -> None:
        from repro_torch.core import SweepEngine

        self.make_inputs()
        self.points = [self._program_points(r, g)
                       for r, g in zip(self.pool, self.grids)]
        # one whole sweep of the first trace: every shape the window uses
        SweepEngine(device=self.device).run(self.points[0])
        self.sync()

    def window(self, seconds: float) -> dict:
        from repro_torch.core import SweepEngine

        traced = span if self.tracing else (lambda name: contextlib.nullcontext())
        clock = time.perf_counter
        self.results = []           # (pool index, [(costs, labels)])
        self.stats = []
        self.failed = 0
        t0 = clock()
        i = 0
        while clock() - t0 < seconds:
            j = i % len(self.pool)
            eng = SweepEngine(device=self.device)
            t_s = clock()
            with traced("perfbench.sweep"):
                res = eng.run(self.points[j])
            self.results.append((j, [(r.costs.as_dict(),
                                      check.labels(r.state.partition.clique_of))
                                     for r in res]))
            self.failed += sum(1 for r in res
                               if not np.isfinite(r.costs.as_dict()["transfer"]))
            st = eng.last_stats
            self.stats.append({
                "schedules": int(eng.last_n_schedules),
                "steps": sum(int(g.get("steps", 0)) for g in st["groups"]),
                "scan_s": sum(float(g.get("scan_s", 0.0))
                              for g in st["groups"]),
                "schedule_s": sum(float(b["schedule_s"]) for b in st["builds"]),
                "cg_s": sum(float(b["cg_s"]) for b in st["builds"])})
            self.stats[-1]["sweep_s"] = clock() - t_s
            i += 1
        t_end = clock()
        self.wall_s = t_end - t0
        pts = len(self.grids[0])
        self.attempted = pts * len(self.results)
        work = sum(len(self.grids[j]) * self.pool[j].n_requests
                   for j, _ in self.results)
        return {"sweep_lane_req_per_s": work / self.wall_s}

    def counters(self) -> dict:
        tot = {k: sum(s[k] for s in self.stats) for k in self.stats[0]}
        tot["sweep_s"] = [s["sweep_s"] for s in self.stats]
        reqs = [self.pool[j].n_requests for j, _ in self.results]
        return {"sweeps": len(self.results), "requests": sum(reqs),
                "schedule_requests": sum(
                    r * s["schedules"] for r, s in zip(reqs, self.stats)),
                "wall_s": self.wall_s, **tot}

    def release(self) -> None:
        pass

    def sample(self) -> list:
        """(sweep, point) pairs to check: one point of each rho (each
        schedule group), its alpha drawn from the seed, and the grid's
        first and last points (the scan's edge lanes), each from another
        sweep of the window while there are enough, in an order drawn
        from the seed."""
        rng = np.random.default_rng(inputs.derived_seed(self.seed, 2))
        n_a, n_r = int(self.mix["alphas"][2]), int(self.mix["rhos"][2])
        pts = {0, n_a * n_r - 1}
        pts.update(r * n_a + int(rng.integers(n_a)) for r in range(n_r))
        sweeps = rng.permutation(len(self.results))
        return [(int(sweeps[i % len(sweeps)]), p)
                for i, p in enumerate(sorted(pts))]

    def reference_point(self, j: int, p: int, dtype) -> tuple:
        req = self.pool[j]
        params, t_cg = self.grids[j][p]
        cp = ref_cost.CostParams(**params)
        env = ref_cost.CacheEnvironment(req.n, req.m, cp, item_sizes=req.sizes)
        ref = ReferenceStream(
            AKPCConfig(cp, t_cg, top_frac=self.policy["top_frac"]), env,
            self.cfg["pricing"]["cost_model"], dtype=dtype)
        ref.feed(req.items, req.servers, req.times)
        return ref.costs.as_dict(), check.labels(ref.partition.clique_of)

    def check(self, dtype=np.float64) -> dict:
        pairs = []
        for s, p in self.sample():
            j, res = self.results[s]
            want, want_l = self.reference_point(j, p, np.float64)
            if dtype != np.float64:
                # the control: the reference in a lower precision in the
                # program's place
                got, got_l = self.reference_point(j, p, dtype)
            else:
                got, got_l = res[p]
            pairs.append((got, got_l, want, want_l))
        return check.compare(pairs)
