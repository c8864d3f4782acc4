"""A closed-loop request stream through one ``LiveServingEngine``.

Set-up makes one trace of the mix's length from the seed and warms the
cell's own path on a throwaway engine over the trace's head.  The window
submits the trace in arrival slices as fast as ``submit`` returns, pass
k shifted by k times a whole number past its last time (times keep
rising; ``inputs.pass_shift``), then drains
the engine (its costs and state synced).  The rate is every request
submitted and settled over the time from the window's start to the end
of that drain.  A slice settles at the first poll (after each submit,
and at the drain's end) that finds its future done.

The check replays the same requests (every whole pass and the last
pass's prefix) through the plain reference and compares the costs and
the partition after the last window boundary.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np

from .. import check, inputs
from . import Base
from ..reference.akpc import AKPCConfig, ReferenceStream
from ..reference import cost as ref_cost
from ..tracing import span


class Driver(Base):

    # -- set-up ---------------------------------------------------------------
    def make_inputs(self) -> None:
        """The requests, prices and T_CG of the run (no program)."""
        cfg, mix = self.cfg, self.mix
        self.req = req = inputs.requests(
            cfg["generator"], mix["requests"],
            inputs.derived_seed(self.seed, 0))
        pricing = cfg["pricing"]
        self.params = dict(cfg["params"])
        self.lam_j, self.mu_j = inputs.server_prices(
            pricing, req.m, self.params.get("lam", 1.0),
            self.params.get("mu", 1.0))
        self.cost_model = pricing["cost_model"]
        policy = {**cfg["policy"], **self.cell["workload"].get("policy", {})}
        self.t_cg = inputs.t_cg_for(
            float(policy.pop("t_cg_span")),
            inputs.max_dt(self.params, self.lam_j, self.mu_j))
        self.policy_kw = policy
        self.shift = inputs.pass_shift(req)

    def served(self, n_requests: int) -> None:
        """Set the served extent to the stream's first ``n_requests``."""
        R = self.req.n_requests
        self.passes, self.offset = divmod(int(n_requests), R)

    def setup(self) -> None:
        from repro_torch.core.cost import CacheEnvironment, CostParams
        from repro_torch.core.policy import get_policy
        from repro_torch.serving import LiveServingEngine

        self.make_inputs()
        cfg, mix, req, policy = self.cfg, self.mix, self.req, self.policy_kw
        params = CostParams(**self.params)
        env = None
        if self.cost_model != "table1" or req.sizes is not None:
            env = CacheEnvironment(req.n, req.m, params, lam_j=self.lam_j,
                                   mu_j=self.mu_j, item_sizes=req.sizes)
        kw = dict(params=params, t_cg=self.t_cg, **policy)
        if env is not None:
            kw.update(env=env, cost_model=self.cost_model)

        def engine():
            return LiveServingEngine(
                get_policy(cfg["policy_name"], **kw), req.n, req.m, env=env,
                chunk_size=mix["chunk"], ring=mix["ring"], cgm="auto",
                device=self.device)

        warm = engine()
        head = min(int(mix["warmup_requests"]), req.n_requests)
        for s in range(0, head, mix["slice"]):
            e = min(s + mix["slice"], head)
            warm.submit(req.items[s:e], req.servers[s:e], req.times[s:e])
        warm.drain()
        self.sync()
        del warm
        self.eng = engine()
        self.sync()

    # -- the window -------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        req, eng, sl = self.req, self.eng, int(self.mix["slice"])
        items, servers, times = req.items, req.servers, req.times
        R = req.n_requests
        traced = span if self.tracing else (lambda name: contextlib.nullcontext())
        pend: collections.deque = collections.deque()
        settle = []
        submitted = k = s = 0
        clock = time.perf_counter
        t0 = clock()
        while clock() - t0 < seconds:
            e = min(s + sl, R)
            tm = times[s:e] + k * self.shift if k else times[s:e]
            t_sub = clock()
            with traced("perfbench.submit"):
                fut = eng.submit(items[s:e], servers[s:e], tm)
            pend.append((t_sub, fut, e - s))
            submitted += e - s
            while pend and pend[0][1].done():
                settle.append(clock() - pend.popleft()[0])
            s = e
            if s == R:
                s, k = 0, k + 1
        with traced("perfbench.drain"):
            eng.drain()
            self.sync()
        t_end = clock()
        self.failed = 0
        for t_sub, fut, n in pend:
            if fut.done():
                settle.append(t_end - t_sub)
            else:
                self.failed += n
        self.passes, self.offset = k, s
        self.submitted = self.attempted = submitted
        self.settle_s = np.asarray(settle)
        self.wall_s = t_end - t0
        return {"serve_req_per_s": submitted / self.wall_s}

    def counters(self) -> dict:
        eng = self.eng
        pol = eng.policy
        return {
            "requests": self.submitted, "passes": self.passes,
            "path": "device_cgm" if eng._cgm else "host_schedule",
            "windows": int(pol.n_windows), "cg_seconds": float(pol.cg_seconds),
            "chunks": eng.chunks, "ring_waits": eng.ring_waits,
            "cost_reads": eng.cost_reads, "loop_stats": dict(eng.loop_stats),
            "settle_s": self.settle_s, "wall_s": self.wall_s,
        }

    # -- the check ----------------------------------------------------------------
    def release(self) -> None:
        eng = self.eng
        self.got_costs = eng.costs.as_dict()
        self.got_labels = check.labels(eng.partition.clique_of)
        del self.eng, eng

    def reference(self, dtype=np.float64) -> tuple[dict, np.ndarray]:
        """The plain reference over the window's requests."""
        req = self.req
        params = ref_cost.CostParams(**self.params)
        env = ref_cost.CacheEnvironment(
            req.n, req.m, params, lam_j=self.lam_j, mu_j=self.mu_j,
            item_sizes=req.sizes)
        pol = self.policy_kw
        ref = ReferenceStream(
            AKPCConfig(params, self.t_cg, top_frac=pol["top_frac"]),
            env, self.cost_model, dtype=dtype)
        for k in range(self.passes + 1):
            stop = req.n_requests if k < self.passes else self.offset
            if stop:
                tm = req.times[:stop] + k * self.shift if k else req.times[:stop]
                ref.feed(req.items[:stop], req.servers[:stop], tm)
        return ref.costs.as_dict(), check.labels(ref.partition.clique_of)

    def check(self, dtype=np.float64) -> dict:
        want, labels = self.reference(np.float64)
        if dtype != np.float64:
            # the control: the reference in a lower precision in the
            # program's place
            got, got_labels = self.reference(dtype)
        else:
            got, got_labels = self.got_costs, self.got_labels
        return check.compare([(got, got_labels, want, labels)])
