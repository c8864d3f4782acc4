"""The port's last examples and ``configs/paper.py`` against ``repro``.

``repro_torch.examples.quickstart`` and ``cdn_simulation`` run on the CPU
at 2,000 requests a trace and return their numbers; the same calls go
through ``repro`` (its numpy replay, ``opt_lower_bound`` and
``CacheSession``) on the same seeded traces.  Costs agree at 1e-9
relative (the reference's own bar between its backends).  The learned
vignette's scorer is trained by the port (``repro``'s ``train_policy``
needs ``jax.experimental.enable_x64``, absent from this jax; ROADMAP
queue 3); its weights then serve through ``repro``'s ``learned`` policy.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import paper as ref_paper
from repro.core import CacheEnvironment as RefEnv
from repro.core import CacheSession as RefSession
from repro.core import CostParams as RefParams
from repro.core import get_cost_model as ref_cost_model
from repro.core import get_policy as ref_get_policy
from repro.core import opt_lower_bound as ref_opt
from repro.core import run_policy as ref_run_policy
from repro.learned.model import LearnedParams as RefLearnedParams
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import paper_trace as ref_paper_trace
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.configs import paper
from repro_torch.core import CacheEnvironment, CostParams
from repro_torch.examples import cdn_simulation, quickstart
from repro_torch.learned import train_policy
from repro_torch.traces import SynthConfig, synth_trace

N = 2000
RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want):
    assert abs(got - want) <= RTOL * max(abs(want), 1e-30), (got, want)


def same_costs(got, want):
    for f in ("transfer", "caching", "total"):
        close(getattr(got, f), getattr(want, f))
    assert got.n_requests == want.n_requests


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def ref_t_cg(env, cost_model="table1"):
    return 0.3 * float(ref_cost_model(cost_model, env).dt().max())


def test_paper_constants_equal_the_reference():
    assert dataclasses.asdict(paper.PAPER_PARAMS) == dataclasses.asdict(
        ref_paper.PAPER_PARAMS)
    for name in ("BATCH_SIZE", "N_SERVERS", "N_ITEMS", "D_MAX"):
        assert getattr(paper, name) == getattr(ref_paper, name)


@pytest.mark.parametrize("kind", ["netflix", "spotify"])
def test_quickstart_equals_reference(kind, capsys):
    got = quickstart.main(["--requests", str(N), "--kind", kind,
                           "--device", "cpu"])
    assert "final streaming total" in capsys.readouterr().out
    params = RefParams()
    tr = ref_paper_trace(kind, n_requests=N)
    t_cg = ref_t_cg(RefEnv.from_trace(tr, params))
    close(got["t_cg"], t_cg)
    for label, name, kw in quickstart.RUNS:
        kw = {k: (t_cg if k == "t_cg" else v) for k, v in kw.items()}
        want = ref_run_policy(ref_get_policy(name, params=params, **kw), tr)
        same_costs(got["rows"][label], want.costs)
    same_costs(got["rows"]["OPT (lower bound)"], ref_opt(tr, params))
    sess = RefSession(ref_get_policy("akpc", params=params, t_cg=t_cg,
                                     top_frac=1.0), tr.n, tr.m)
    running = []
    quarter = max(1, tr.n_requests // 4)
    C = quickstart.CHUNK
    for s in range(0, tr.n_requests, C):
        costs = sess.feed(tr.items[s:s + C], tr.servers[s:s + C],
                          tr.times[s:s + C])
        if (s // C) % (quarter // C + 1) == 0:
            running.append((sess.now, costs.n_requests, costs.total))
    close(got["stream_total"], sess.costs.total)
    assert len(got["running"]) == len(running)
    for g, w in zip(got["running"], running):
        assert g[1] == w[1]
        close(g[0], w[0])
        close(g[2], w[2])


def test_cdn_sweep_equals_reference(capsys):
    got = cdn_simulation.sweep("cpu", n_requests=N)
    assert set(got) == {(k, a) for k in ("netflix", "spotify")
                        for a in (0.6, 0.8, 1.0)}
    for (kind, alpha), row in got.items():
        tr = ref_paper_trace(kind, n_requests=N)
        params = RefParams(alpha=alpha)
        t_cg = ref_t_cg(RefEnv.from_trace(tr, params))
        kw = dict(params=params, t_cg=t_cg, top_frac=1.0)
        close(row["akpc"], ref_run_policy(ref_get_policy("akpc", **kw),
                                          tr).total)
        close(row["packcache"], ref_run_policy(
            ref_get_policy("packcache", **kw), tr).total)
        close(row["no_packing"], ref_run_policy(
            ref_get_policy("no_packing", params=params), tr).total)
        close(row["opt"], ref_opt(tr, params).total)
    assert "vs OPT=1" in capsys.readouterr().out


def test_checkpoint_vignette_equals_reference():
    got = cdn_simulation.live_checkpoint_vignette("cpu", n_requests=N)
    params = RefParams()
    tr = ref_paper_trace("netflix", n_requests=N)
    t_cg = ref_t_cg(RefEnv.from_trace(tr, params))
    sess = RefSession(ref_get_policy("akpc", params=params, t_cg=t_cg,
                                     top_frac=1.0), tr.n, tr.m)
    half = tr.n_requests // 2
    sess.feed(tr.items[:half], tr.servers[:half], tr.times[:half])
    close(got["at_snapshot"], sess.costs.total)
    sess.feed(tr.items[half:], tr.servers[half:], tr.times[half:])
    close(got["primary"], sess.costs.total)
    assert got["standby"] == got["primary"]


def _hetero_trace(synth, config):
    return synth(config(
        kind="netflix", n_items=60, n_servers=100, n_requests=N,
        t_max=72.0, bundle_cover=1.0, bundle_zipf=0.7, server_affinity=2,
        seed=0, size_dist="lognormal"))


def test_heterogeneous_vignette_equals_reference():
    got = cdn_simulation.heterogeneous_vignette("cpu", n_requests=N)
    params = RefParams()
    tr = _hetero_trace(ref_synth_trace, RefSynthConfig)
    skew = RefEnv.skewed(tr.n, tr.m, params, price_sigma=1.0, seed=1)
    env = RefEnv.from_trace(tr, params, lam_j=skew.lam_j, mu_j=skew.mu_j)
    t_cg = ref_t_cg(env, "heterogeneous")
    kw = dict(params=params, env=env, cost_model="heterogeneous")
    close(got["akpc"], ref_run_policy(ref_get_policy(
        "akpc", t_cg=t_cg, top_frac=1.0, **kw), tr).total)
    close(got["no_packing"], ref_run_policy(ref_get_policy(
        "no_packing", **kw), tr).total)
    assert got["model"] == "heterogeneous"


def _regime(synth, config, seed):
    return synth(config(
        kind="netflix", n_items=60, n_servers=12, n_requests=N,
        t_max=600.0, bundle_cover=1.0, bundle_zipf=0.7, server_affinity=2,
        load_profile="regime_shift", load_strength=0.25, load_peak=0.4,
        seed=seed))


def test_learned_vignette_serves_like_reference():
    got = cdn_simulation.learned_vignette("cpu", n_requests=N)
    # the vignette's scorer, trained again by the port (deterministic on
    # the CPU), serves through the reference's ``learned`` policy
    yesterday = _regime(synth_trace, SynthConfig, 200)
    pparams = CostParams(rho=4.0)
    env = CacheEnvironment.from_trace(yesterday, pparams)
    span = float(yesterday.times[-1] - yesterday.times[0])
    t_cg = min(max(cdn_simulation._t_cg(env), span / 50.0), span / 4.0)
    lp = train_policy(yesterday, t_cg=t_cg, params=pparams, device="cpu")
    ref_lp = RefLearnedParams.from_tree(np_tree(lp.tree()))
    today = _regime(ref_synth_trace, RefSynthConfig, 101)
    params = RefParams(rho=4.0)
    for name, kw in (("no_packing", {}), ("ttl", dict(t_cg=t_cg)),
                     ("learned", dict(t_cg=t_cg, learned=ref_lp))):
        close(got[name], ref_run_policy(ref_get_policy(
            name, params=params, **kw), today).total)


def test_cdn_simulation_main_runs_every_vignette(capsys):
    got = cdn_simulation.main(["--requests", "600", "--device", "cpu"])
    assert set(got) == {"sweep", "checkpoint", "heterogeneous", "learned"}
    out = capsys.readouterr().out
    assert "standby resumed bit-identically" in out
    assert "learned saves" in out
