"""The port's device clique generation against the frozen ``cliques_ref`` oracle.

The port's partition at EVERY chained T_CG boundary must equal the oracle's
element for element, over a theta x gamma x omega grid at n = 48 and at
n = 4096 (a compact hot space far below n), on the CPU with the plain
kernel versions.  The oracle walk is the one of tests/test_device_cgm.py.
"""
import numpy as np
import pytest

from repro.core import cliques_ref as oracle
from repro.core.crm import build_window_crm
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.core import CostParams, get_policy
from repro_torch.core.cgm import init_cgm_carry, run_cgm_schedule
from repro_torch.core.cgm_schedule import (
    build_cgm_schedule,
    cgm_spec,
    policy_hot_dims,
)
from repro_torch.core.replay import TorchReplayEngine
from repro_torch.traces import SynthConfig, synth_trace

N_ITEMS = 48
T_CG = 0.73
TOP_FRAC = 0.5
GRID = [(th, g, om) for th in (0.1, 0.3) for g in (0.6, 0.95)
        for om in (3, 5)]


def _oracle_trajectory(trace, theta, gamma, omega, *, enable_split=True,
                       enable_acm=True, t_cg=T_CG):
    """The frozen-oracle partition at every T_CG boundary, walking the
    trace as the replay does."""
    times = trace.times
    R = times.shape[0]
    next_cg = float(times[0]) + t_cg
    win_start = pos = 0
    prev = prev_crm = None
    parts = []
    while pos < R:
        cut = int(np.searchsorted(times, next_cg, side="left"))
        if cut <= pos:
            t = float(times[pos])
            crm = build_window_crm(
                trace.items[win_start:pos], trace.n, theta,
                top_frac=TOP_FRAC)
            prev = oracle.generate_cliques(
                prev, prev_crm, crm, trace.n, omega, gamma,
                enable_split=enable_split, enable_approx_merge=enable_acm)
            parts.append(prev.clique_of.copy())
            prev_crm = crm
            win_start = pos
            while next_cg <= t:
                next_cg += t_cg
            continue
        pos = cut
    return parts


def _port_boundaries(trace, policy, t_cg):
    """The port's slot map after every boundary (CPU, plain versions)."""
    policy.bind(trace.n, trace.m)
    eng = TorchReplayEngine(trace.n, trace.m, policy.params, device="cpu")
    sched = build_cgm_schedule(trace, t_cg, uses_sizes=False,
                               hot_dims=policy_hot_dims(policy))
    cfg = policy.config
    carry0 = init_cgm_carry(eng.state, None, None, schedule=sched,
                            uses_sizes=False, item_sizes=None, device="cpu")
    final, ofs, _ = run_cgm_schedule(
        sched, eng._spec, eng._statics, cgm_spec(cfg, cfg.params, trace.n),
        carry0, None, enable_split=cfg.enable_split,
        enable_acm=cfg.enable_approx_merge)
    return sched, ofs.numpy(), final["of"].numpy()


@pytest.fixture(scope="module")
def traces():
    kw = dict(kind="netflix", n_items=N_ITEMS, n_servers=6, n_requests=900,
              t_max=9.0, bundle_cover=1.0, bundle_zipf=0.7, seed=5)
    return ref_synth_trace(RefSynthConfig(**kw)), synth_trace(SynthConfig(**kw))


@pytest.mark.parametrize("theta,gamma,omega", GRID)
def test_partitions_match_oracle_grid(traces, theta, gamma, omega):
    ref_trace, trace = traces
    pol = get_policy("akpc", params=CostParams(theta=theta, gamma=gamma,
                                               omega=omega),
                     t_cg=T_CG, top_frac=TOP_FRAC)
    sched, ofs, final_of = _port_boundaries(trace, pol, T_CG)
    want = _oracle_trajectory(ref_trace, theta, gamma, omega)
    assert sched.boundary_steps.size >= 3          # chained windows
    assert len(want) == ofs.shape[0]
    for w, ref_of in enumerate(want):
        assert np.array_equal(ofs[w], ref_of), f"window {w}"
    assert np.array_equal(final_of, want[-1])


@pytest.mark.parametrize("name", ["akpc_no_acm", "akpc_base"])
def test_ablations_match_oracle(traces, name):
    ref_trace, trace = traces
    pol = get_policy(name, params=CostParams(theta=0.2, gamma=0.85, omega=4),
                     t_cg=T_CG, top_frac=TOP_FRAC)
    cfg = pol.config
    _, ofs, _ = _port_boundaries(trace, pol, T_CG)
    want = _oracle_trajectory(
        ref_trace, 0.2, 0.85, 4 if cfg.enable_split else trace.n,
        enable_split=cfg.enable_split, enable_acm=cfg.enable_approx_merge)
    assert len(want) == ofs.shape[0]
    for w, ref_of in enumerate(want):
        assert np.array_equal(ofs[w], ref_of), f"window {w}"


def test_big_catalog_chained_parity_vs_oracle():
    """n = 4096: the compact hot space reproduces the oracle at every
    chained window (the big_trace fixture of tests/test_device_cgm.py)."""
    kw = dict(kind="spotify", n_items=4096, n_servers=12, n_requests=1500,
              t_max=8.0, bundle_cover=1.0, bundle_zipf=0.7, seed=3)
    ref_trace = ref_synth_trace(RefSynthConfig(**kw))
    trace = synth_trace(SynthConfig(**kw))
    pol = get_policy("akpc", params=CostParams(theta=0.2, gamma=0.85,
                                               omega=4),
                     t_cg=2.0, top_frac=TOP_FRAC)
    sched, ofs, final_of = _port_boundaries(trace, pol, 2.0)
    assert sched.boundary_steps.size >= 3
    assert sched.h < trace.n                       # genuinely compact
    want = _oracle_trajectory(ref_trace, 0.2, 0.85, 4, t_cg=2.0)
    assert len(want) == ofs.shape[0]
    for w, ref_of in enumerate(want):
        assert np.array_equal(ofs[w], ref_of), f"window {w}"
    assert np.array_equal(final_of, want[-1])
