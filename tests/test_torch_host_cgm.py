"""The port's host clique generation against the JAX package's and the oracle.

``repro_torch.core.cliques.generate_cliques`` and the host
``AKPCPolicy.on_window`` must give partitions element for element equal
to ``repro.core.cliques``' and to the frozen scalar oracle
``repro.core.cliques_ref``, over a (theta x gamma x omega) grid with
windows chained (previous partition + previous CRM) as AKPC runs them.
The CRM of Alg. 2 (``build_window_crm``) and the merge scores are held
against the reference too, with and without the kernel hooks' form
(the dense ``H^T H`` / ``M A M^T`` products the card runs).
"""
import numpy as np
import pytest
import torch

from repro.core import cliques as ref_cliques
from repro.core import cliques_ref as oracle
from repro.core import crm as ref_crm
from repro.core import get_policy as ref_get_policy
from repro.core import CostParams as RefParams
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.core import CostParams, get_policy
from repro_torch.core import cliques, crm
from repro_torch.kernels import clique_pair_edges_plain, crm_update_plain

N_ITEMS = 48
N_WINDOWS = 3


def _windows(kind, seed=0):
    tr = ref_synth_trace(RefSynthConfig(
        kind=kind, n_items=N_ITEMS, n_servers=10, n_requests=240,
        t_max=12.0, bundle_cover=1.0, seed=seed))
    per = tr.items.shape[0] // N_WINDOWS
    return [tr.items[w * per: (w + 1) * per] for w in range(N_WINDOWS)]


def _crm_matmul(H):
    """The hook form the card runs, here with the plain version."""
    return crm_update_plain(torch.from_numpy(H)).numpy()


def _pair_edges(M, A):
    return clique_pair_edges_plain(torch.from_numpy(M),
                                   torch.from_numpy(A)).numpy()


def _same_crm(a, b):
    assert np.array_equal(a.hot_items, b.hot_items)
    assert np.array_equal(a.raw, b.raw)
    assert np.array_equal(a.norm, b.norm)
    assert np.array_equal(a.binary, b.binary)


def _same_partition(a, b, ctx):
    assert a.cliques == b.cliques, ctx
    assert np.array_equal(a.clique_of, b.clique_of), ctx


@pytest.mark.parametrize("hook", [False, True])
@pytest.mark.parametrize("kind", ["netflix", "spotify"])
@pytest.mark.parametrize("theta,top_frac_of", [(0.1, "window"),
                                               (0.3, "catalog")])
def test_build_window_crm_equal(kind, theta, top_frac_of, hook):
    for items in _windows(kind, seed=2):
        got = crm.build_window_crm(
            items, N_ITEMS, theta, 0.5, top_frac_of=top_frac_of,
            crm_matmul=_crm_matmul if hook else None)
        want = ref_crm.build_window_crm(items, N_ITEMS, theta, 0.5,
                                        top_frac_of=top_frac_of)
        _same_crm(got, want)


def test_cooccurrence_counts_sparse_path_equal():
    """Windows large enough for the pair-scatter path (B n^2 > 2^25)."""
    rng = np.random.default_rng(0)
    items = rng.integers(-1, 300, size=(600, 6))
    assert np.array_equal(crm.cooccurrence_counts(items, 300),
                          ref_crm.cooccurrence_counts(items, 300))
    assert np.array_equal(crm.minmax_normalise(np.arange(6).reshape(2, 3)),
                          ref_crm.minmax_normalise(np.arange(6).reshape(2, 3)))


def test_edge_diff_arrays_equal():
    wins = _windows("spotify", seed=4)
    prev = None
    for items in wins:
        cur_p = crm.build_window_crm(items, N_ITEMS, 0.15, 0.5)
        cur_r = ref_crm.build_window_crm(items, N_ITEMS, 0.15, 0.5)
        got = crm.edge_diff_arrays(prev[0] if prev else None, cur_p)
        want = ref_crm.edge_diff_arrays(prev[1] if prev else None, cur_r)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        prev = (cur_p, cur_r)


@pytest.mark.parametrize("omega", [3, 4, 5])
@pytest.mark.parametrize("gamma", [0.6, 0.85, 0.95])
@pytest.mark.parametrize("theta", [0.1, 0.3])
def test_generate_cliques_equal_reference_and_oracle(omega, gamma, theta):
    """Chained windows: port == repro == oracle at every event."""
    for kind in ("netflix", "spotify"):
        wins = _windows(kind)
        pp = pr = po = None
        cp = cr = None
        for w, items in enumerate(wins):
            c_p = crm.build_window_crm(items, N_ITEMS, theta, top_frac=0.5)
            c_r = ref_crm.build_window_crm(items, N_ITEMS, theta,
                                           top_frac=0.5)
            npart = cliques.generate_cliques(pp, cp, c_p, N_ITEMS, omega,
                                             gamma, pair_edges=_pair_edges)
            nr = ref_cliques.generate_cliques(pr, cr, c_r, N_ITEMS, omega,
                                              gamma)
            no = oracle.generate_cliques(po, cr, c_r, N_ITEMS, omega, gamma)
            ctx = f"{kind} omega={omega} gamma={gamma} theta={theta} w={w}"
            _same_partition(npart, nr, ctx)
            _same_partition(npart, no, ctx)
            pp, cp, pr, cr, po = npart, c_p, nr, c_r, no


@pytest.mark.parametrize("split,merge", [(True, True), (True, False),
                                         (False, True), (False, False)])
def test_ablation_variants_equal(split, merge):
    wins = _windows("spotify", seed=3)
    pp = pr = cp = cr = None
    for items in wins:
        c_p = crm.build_window_crm(items, N_ITEMS, 0.15, top_frac=0.5)
        c_r = ref_crm.build_window_crm(items, N_ITEMS, 0.15, top_frac=0.5)
        npart = cliques.generate_cliques(
            pp, cp, c_p, N_ITEMS, 5, 0.85, enable_split=split,
            enable_approx_merge=merge)
        nr = oracle.generate_cliques(
            pr, cr, c_r, N_ITEMS, 5, 0.85, enable_split=split,
            enable_approx_merge=merge)
        _same_partition(npart, nr, f"split={split} merge={merge}")
        pp, cp, pr, cr = npart, c_p, nr, c_r


@pytest.mark.parametrize("omega,gamma", [(2, 0.5), (5, 0.4)])
def test_unpruned_regime_equal(omega, gamma):
    for items in _windows("netflix", seed=7):
        c_p = crm.build_window_crm(items, N_ITEMS, 0.1, top_frac=1.0)
        c_r = ref_crm.build_window_crm(items, N_ITEMS, 0.1, top_frac=1.0)
        _same_partition(
            cliques.generate_cliques(None, None, c_p, N_ITEMS, omega, gamma,
                                     pair_edges=_pair_edges),
            oracle.generate_cliques(None, None, c_r, N_ITEMS, omega, gamma),
            f"omega={omega} gamma={gamma}")


def test_split_oversized_and_merge_scores_equal():
    rng = np.random.default_rng(5)
    items = _windows("spotify", seed=1)[0]
    c_p = crm.build_window_crm(items, N_ITEMS, 0.1, top_frac=1.0)
    c_r = ref_crm.build_window_crm(items, N_ITEMS, 0.1, top_frac=1.0)
    vp = cliques._CrmView(c_p, N_ITEMS)
    vr = ref_cliques._CrmView(c_r, N_ITEMS)
    big = tuple(sorted(rng.choice(N_ITEMS, 17, replace=False).tolist()))
    assert cliques.split_oversized(big, 4, vp) == \
        ref_cliques.split_oversized(big, 4, vr)
    groups = [tuple(sorted(rng.choice(N_ITEMS, s, replace=False).tolist()))
              for s in (1, 2, 3, 2, 1)]
    for pe in (None, _pair_edges):
        assert np.array_equal(
            cliques.merge_scores(groups, vp, 4, pair_edges=pe),
            ref_cliques.merge_scores(groups, vr, 4))


@pytest.mark.parametrize("name", ["akpc", "akpc_no_acm", "akpc_base"])
@pytest.mark.parametrize("params", [dict(theta=0.2, gamma=0.85, omega=4),
                                    dict(theta=0.1, gamma=0.6, omega=3)])
def test_policy_on_window_equal(name, params):
    """The host ``on_window`` over chained windows, numpy and hook forms."""
    wins = _windows("netflix", seed=9)
    ref = ref_get_policy(name, params=RefParams(**params), t_cg=1.0,
                         top_frac=0.5)
    ref.bind(N_ITEMS, 10)
    ports = []
    for hooks in ({}, dict(crm_matmul=_crm_matmul, pair_edges=_pair_edges)):
        pol = get_policy(name, params=CostParams(**params), t_cg=1.0,
                         top_frac=0.5, **hooks)
        pol.bind(N_ITEMS, 10)
        ports.append(pol)
    for w, items in enumerate(wins):
        want = ref.on_window(items, None, float(w))
        for pol in ports:
            _same_partition(pol.on_window(items, None, float(w)), want,
                            f"{name} w={w}")
    for pol in ports:
        assert pol.n_windows == ref.n_windows
        _same_crm(pol._prev_crm, ref._prev_crm)
        for a, b in zip(pol.size_history, ref.size_history):
            assert np.array_equal(a, b)


def test_cpu_replay_wires_no_hooks():
    """``kernels="auto"`` on the CPU keeps the numpy paths (no hooks), as
    the reference does without a TPU."""
    pol = get_policy("akpc", t_cg=1.0)
    pol.bind(N_ITEMS, 10)
    pol.wire_kernels("cpu")
    assert pol._crm_matmul is None and pol._pair_edges is None
    own = get_policy("akpc", t_cg=1.0, crm_matmul=_crm_matmul)
    own.bind(N_ITEMS, 10)
    own.wire_kernels("cpu")
    assert own._crm_matmul is _crm_matmul
