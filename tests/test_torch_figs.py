"""The port's figure drivers on the CPU, against the reference's.

Small heads of each figure's grid go through the port's drivers
(``repro_torch.bench``) and through the reference's own helpers or
drivers (``benchmarks.*``, whose sweeps run the numpy backend here):
``run_method_grid`` and ``run_methods`` (fig5, fig6 and fig10 grids, OPT
included), ``relative_to_opt`` and the payloads' keys agree at 1e-9;
table1 is equal; the port's copy of the scalar clique oracle gives the
reference's partitions element for element; fig8's ``--smoke`` grid
under the bucketed layout makes one scan a bucket cohort and equals the
reference's numpy run; fig9's size histograms, fig10's smoke gate,
the replay benchmark's batch-1 / batched equality, the sweep benchmark's
mixed-shape gate and the integration benchmark equal the reference.
"""
import json

import numpy as np
import pytest

from benchmarks import common as ref_common
from benchmarks import fig8_scalability as ref_fig8
from benchmarks import fig10_heterogeneous as ref_fig10
from benchmarks.table1_cost_model import main as ref_table1_main
from repro.core import CostParams as RefParams
from repro.core import ReplayEngine as RefReplayEngine
from repro.core import cliques_ref as ref_cliques_ref
from repro.core import get_cost_model as ref_get_cost_model
from repro.core import get_policy as ref_get_policy
from repro.core import run_policy as ref_run_policy
from repro.core.baselines import greedy_pair_matching as ref_pairs
from repro.core.cost import CacheEnvironment as RefEnv
from repro.core.crm import build_window_crm as ref_build_window_crm
from repro.traces import paper_trace as ref_paper_trace

from repro_torch.bench import (
    common,
    fig5,
    fig6,
    fig8,
    fig9,
    fig10,
    integration_bench,
    replay_bench,
    run as bench_run,
    sweep_bench,
    table1,
)
from repro_torch.core import cliques_ref, greedy_pair_matching
from repro_torch.core.crm import build_window_crm
from repro_torch.traces import paper_trace

HEAD = 2000
FIELDS = ("total", "transfer", "caching")


def assert_same_entries(ref: dict, got: dict, tag=""):
    """Two ``{method: {total, transfer, caching, ...}}`` payload entries:
    the same keys, floats at 1e-9, clique-size histograms equal."""
    assert set(ref) == set(got), tag
    for m, r in ref.items():
        g = got[m]
        assert set(r) == set(g), f"{tag} {m}: {set(r) ^ set(g)}"
        for f in FIELDS:
            assert np.isclose(r[f], g[f], rtol=1e-9, atol=1e-9), \
                f"{tag} {m} {f}: {r[f]} != {g[f]}"
        assert r.get("clique_sizes") == g.get("clique_sizes"), f"{tag} {m}"


def _same_trace(ref, port):
    assert np.array_equal(ref.items, port.items)
    assert np.array_equal(ref.servers, port.servers)
    assert np.array_equal(ref.times, port.times)


def test_fig5_grid_equals_reference():
    grid = fig5.grid(HEAD)
    ref_grid = [{"trace": ref_paper_trace(k, n_requests=HEAD),
                 "params": RefParams(), "cost_model": "table1"}
                for k in fig5.KINDS]
    for g, r in zip(grid, ref_grid):
        _same_trace(r["trace"], g["trace"])
    got = common.run_method_grid(grid, device="cpu")
    want = ref_common.run_method_grid(ref_grid, backend="numpy")
    for kind, r, g in zip(fig5.KINDS, want, got):
        assert set(g) == {*common.method_policies(None, 1.0, 1.0), "opt"}
        assert_same_entries(r, g, kind)
        assert ref_common.relative_to_opt(r) == common.relative_to_opt(g)
    payload, rows = fig5.payload_rows(got)
    assert set(payload) == set(fig5.KINDS)
    assert {r[0] for r in rows} >= {f"fig5/{k}/akpc_vs_packcache_saving"
                                    for k in fig5.KINDS}
    json.dumps(payload, default=float)


def test_fig6_grid_equals_reference():
    grid, keys = fig6.grid(HEAD)
    ref_tr = {k: ref_paper_trace(k, n_requests=HEAD) for k in fig6.KINDS}
    ref_grid = [{"trace": ref_tr[kind],
                 "params": RefParams(**{axis: v}),
                 "methods": fig6.METHODS, "cost_model": "table1"}
                for axis, kind, v in keys]
    stats: dict = {}
    got = common.run_method_grid(grid, device="cpu", stats=stats)
    want = ref_common.run_method_grid(ref_grid, backend="numpy")
    for key, r, g in zip(keys, want, got):
        assert_same_entries(r, g, str(key))
    # alpha never enters the clique generation: far fewer schedules than
    # points, and one scan a cohort
    assert stats["schedules"] < len(grid)
    payload, _ = fig6.payload_rows(keys, got)
    assert set(payload) == {"alpha", "rho", "cost_model"}


def test_fig10_grid_equals_reference():
    grid, keys = fig10.grid(HEAD)
    got = fig10.payload_of(HEAD, keys,
                           common.run_method_grid(grid, device="cpu"))
    want = ref_fig10.run_grid(HEAD)
    assert set(got) == set(want) and set(got["grid"]) == set(want["grid"])
    for key, r in want["grid"].items():
        g = got["grid"][key]
        assert g["akpc_vs_no_packing_saving_pct"] == \
            r["akpc_vs_no_packing_saving_pct"]
        for m in fig10.METHODS:
            for f in FIELDS:
                assert np.isclose(r[m][f], g[m][f], rtol=1e-9, atol=1e-9), \
                    f"{key} {m} {f}"


def test_fig10_smoke_gate_and_run_methods_equal_reference():
    rc, got = fig10.smoke("cpu")
    assert rc == 0
    tr = fig10.smoke_trace()
    ref_tr = ref_fig10.synth_trace(ref_fig10.SynthConfig(
        kind="netflix", n_items=60, n_servers=100, n_requests=20_000,
        t_max=72.0, bundle_cover=1.0, bundle_zipf=0.7, server_affinity=2,
        mean_session_len=6.0, seed=0, size_dist="lognormal"))
    _same_trace(ref_tr, tr)
    want = ref_common.run_methods(
        ref_tr, RefParams(), methods=("no_packing", "akpc"),
        env=ref_fig10.env_for(ref_tr, RefParams(), 1.0),
        cost_model="heterogeneous")
    assert_same_entries(want, got, "fig10 smoke")


def test_relative_to_opt_and_reference_key():
    res = {"opt": {"total": 2.0}, "akpc": {"total": 3.0}}
    assert common.relative_to_opt(res) == ref_common.relative_to_opt(res)
    with pytest.raises(KeyError, match="no_packing"):
        common.relative_to_opt({"akpc": {"total": 1.0}})
    assert common.relative_to_opt(res, reference="akpc")["opt"] == 0.6667


def test_run_method_grid_refuses_unknown_backend():
    with pytest.raises(ValueError, match="unknown sweep backend"):
        common.run_method_grid([{"trace": paper_trace("netflix", 100)}],
                               backend="numpy", device="cpu")


def test_table1_equals_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_common, "RESULTS_DIR", str(tmp_path))
    want = ref_table1_main()
    payload, rows = table1.table()
    assert rows == want
    assert set(payload) == set(table1.BUNDLES)


@pytest.mark.parametrize("n,omega,gamma,theta", [
    (60, 5, 0.85, 0.2), (300, 3, 0.6, 0.1), (1000, 5, 0.85, 0.2),
    (200, 7, 1.0, 0.3)])
def test_cliques_ref_equals_reference(n, omega, gamma, theta):
    """The port's copy of the scalar oracle: element-for-element the
    reference's partitions, on a chain of windows (adjust from the
    previous window's CRM)."""
    tr = fig9.runtime_trace(n)
    prev = ref_prev = crm_prev = ref_crm_prev = None
    for lo in range(0, 20000, 5000):
        items = tr.items[lo:lo + 5000]
        crm = build_window_crm(items, n, theta=theta, top_frac=0.1,
                               top_frac_of="catalog")
        ref_crm = ref_build_window_crm(items, n, theta=theta, top_frac=0.1,
                                       top_frac_of="catalog")
        prev = cliques_ref.generate_cliques(prev, crm_prev, crm, n, omega,
                                            gamma)
        ref_prev = ref_cliques_ref.generate_cliques(
            ref_prev, ref_crm_prev, ref_crm, n, omega, gamma)
        assert prev.cliques == ref_prev.cliques
        assert np.array_equal(prev.clique_of, ref_prev.clique_of)
        crm_prev, ref_crm_prev = crm, ref_crm


def test_fig9_smoke_and_size_dist_equal_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    assert fig9.main(["--smoke", "--device", "cpu"]) == 0
    assert (tmp_path / "fig9_cliques_runtime_torch.json").exists()
    dist, _ = fig9.size_dist(HEAD, "cpu")
    params = RefParams()
    for kind in fig9.KINDS:
        tr = ref_paper_trace(kind, n_requests=HEAD)
        t_cg = ref_common.t_cg_for(tr, params)
        for name in fig9.VARIANTS:
            res = ref_run_policy(ref_get_policy(
                name, params=params, t_cg=t_cg, top_frac=1.0), tr)
            sizes = np.concatenate(res.size_history)
            assert dist[kind][name] == {
                "hist": np.bincount(sizes.astype(int),
                                    minlength=11)[:11].tolist(),
                "mean": round(float(sizes.mean()), 2)}, (kind, name)


def test_fig8_smoke_equals_reference():
    grid, labels = fig8.build_grid(smoke=True)
    ref_grid, ref_labels = ref_fig8.build_grid(smoke=True)
    assert labels == ref_labels
    for g, r in zip(grid, ref_grid):
        _same_trace(r["trace"], g["trace"])
        assert g.get("t_cg") == r.get("t_cg")
    res, stats = fig8.run(grid, device="cpu")
    scans = len(stats["groups"])
    k = fig8.n_cohorts(grid)
    assert k == ref_fig8.n_cohorts(ref_grid) and 1 < k < len(grid)
    assert scans <= k
    want, _ = ref_fig8._run(ref_grid, "numpy")
    for lab, r, g in zip(labels, want, res):
        assert_same_entries(r, g, str(lab))
    got_p = fig8.payload_of(grid, labels, res, scans)
    want_p = ref_fig8._payload(ref_grid, ref_labels, want, 0)
    for axis in ("servers", "items", "batch"):
        assert set(got_p[axis]) == set(want_p[axis])
        for val, w in want_p[axis].items():
            assert got_p[axis][val]["rel"] == w["rel"], (axis, val)
            assert np.isclose(got_p[axis][val]["akpc_abs"], w["akpc_abs"],
                              rtol=1e-9, atol=1e-9), (axis, val)
    ref_sl = {k2: v for k2, v in want_p["state_layout"].items()
              if k2 != "compiles"}
    got_sl = {k2: v for k2, v in got_p["state_layout"].items()
              if k2 != "scans"}
    assert got_sl == ref_sl
    assert fig8.smoke_gate(grid, labels, res, scans, "cpu") == []


def test_sweep_bench_mixed_shape_gate():
    rec = sweep_bench.mixed_shape_gate("cpu")
    assert rec["cohorts"] == 2 and rec["scans"] <= 2 and rec["points"] == 4


def test_replay_bench_batch1_equals_batched_and_reference():
    tr = paper_trace("netflix", n_requests=HEAD)
    ref_tr = ref_paper_trace("netflix", n_requests=HEAD)
    part = greedy_pair_matching(tr.items, tr.n, 0.2, 1.0)
    assert part.cliques == ref_pairs(ref_tr.items, ref_tr.n, 0.2,
                                     1.0).cliques
    c1, _ = replay_bench.replay(tr, part, 1, "cpu")
    cb, _ = replay_bench.replay(tr, part, 4096, "cpu")
    replay_bench.equal_costs(c1, cb)
    env = RefEnv.from_trace(ref_tr, RefParams())
    eng = RefReplayEngine(ref_tr.n, ref_tr.m, env=env,
                          cost_model=ref_get_cost_model("table1", env))
    eng.install_partition(ref_pairs(ref_tr.items, ref_tr.n, 0.2, 1.0),
                          now=0.0)
    eng.replay(ref_tr, batch_size=4096)
    replay_bench.equal_costs(eng.costs, cb)


def test_integration_bench_equals_reference(tmp_path, monkeypatch):
    from benchmarks import integration_bench as ref_integration

    monkeypatch.setattr(ref_common, "RESULTS_DIR", str(tmp_path))
    want = ref_integration.main()
    got_payload, got = integration_bench.run("session", "cpu")
    assert got == want
    with open(tmp_path / "integration_bench.json") as f:
        want_payload = json.load(f)
    assert json.loads(json.dumps(got_payload, default=float)) == want_payload


def test_suite_driver_runs_table1(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    assert bench_run.main(["table1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "suite/table1," in out and "done" in out
    assert (tmp_path / "table1_cost_model_torch.json").exists()
    assert [s for s, _ in bench_run.SUITES] == [
        "replay", "sweep", "table1", "fig5", "fig6", "fig7", "fig8", "fig9",
        "fig10", "kernels", "integration", "roofline"]
