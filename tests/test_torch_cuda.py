"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device and ``nvcc`` (the kernels are built from
``src/repro_torch/csrc`` at first use).  Every test carries the ``gpu``
marker and takes the ``cuda_device`` fixture, which skips it when no
device is present (decided when the test runs, not when the file is
imported).  Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

This file imports neither jax nor ``repro``, so it runs where only the
port's dependencies are installed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bench import fig11, kernel_bench
from repro_torch.bench.kernel_bench import worst_cases
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (
    CacheEnvironment,
    CostParams,
    SweepEngine,
    SweepPoint,
    get_policy,
    run_policy,
)
from repro_torch.core.replay import run_policy_torch
from repro_torch.data import PackedDataPipeline, ShardStore
from repro_torch.examples import serve_moe_expert_cache as example
from repro_torch.kernels import (
    KERNELS,
    clique_pair_edges,
    clique_pair_edges_plain,
    crm_update,
    crm_update_plain,
    merge_density,
    merge_density_plain,
    packed_lookup,
    packed_lookup_plain,
    seg_running_argmax,
    seg_running_argmax_plain,
    seg_running_max,
    seg_running_max_plain,
    seg_scan_step,
    seg_scan_step_plain,
    unpacked_lookup,
    unpacked_lookup_plain,
)
from repro_torch.kernels.merge_step import merge_density_lanes_plain
from repro_torch.kernels.packed_lookup import CliqueLookup, clique_lookup
from repro_torch.learned import Scorer, TrainConfig, train_policy, warm_params
from repro_torch.learned.train import adamw_config, train_steps
from repro_torch.models import build_model
from repro_torch.models.common import tree_map
from repro_torch.models.mlp import init_moe, moe_forward
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serving import (
    BatchedServer,
    ExpertCacheManager,
    LiveServingEngine,
    Request,
)
from repro_torch.serving import live as live_module
from repro_torch.traces import SynthConfig, synth_trace

#: the kernels of the AKPC replay with the device clique generation
CGM_KERNELS = ("crm_update", "clique_pair_edges", "merge_density")


pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _incidence(rng, rows, h, d=5):
    H = np.zeros((rows, h), np.float32)
    cols = rng.integers(0, h, size=(rows, d))
    H[np.repeat(np.arange(rows), d), cols.reshape(-1)] = 1.0
    return H


def _membership(rng, S, h, groups=None):
    M = np.zeros((S, h), np.float32)
    grp = rng.integers(-1, S if groups is None else groups, size=h)
    ok = grp >= 0
    M[grp[ok], np.arange(h)[ok]] = 1.0
    return M


def _binary(rng, h, p=0.2):
    A = np.triu(rng.random((h, h)) < p, 1)
    return (A | A.T).astype(np.float32)


@pytest.mark.parametrize("h,rows", [(32, 22976), (100, 3001), (1024, 22912),
                                    (1, 5)])
def test_kernels_equal_plain(cuda_device, h, rows):
    """Each kernel bitwise against its plain version, at the main path's
    hot widths and window rows and at ragged ones; launches counted."""
    rng = np.random.default_rng(h)
    dev = cuda_device
    H = torch.from_numpy(_incidence(rng, rows, h + 1)).to(dev)[:, :h]
    n0 = crm_update.launches
    assert torch.equal(crm_update(H), crm_update_plain(H))
    assert crm_update.launches == n0 + 1
    S = 2 * h
    M = torch.from_numpy(_membership(rng, S, h)).to(dev)
    A = torch.from_numpy(_binary(rng, h)).to(dev)
    X = clique_pair_edges(M, A)
    assert torch.equal(X, clique_pair_edges_plain(M, A))
    sizes = M.sum(dim=1).to(torch.int32)
    for omega, gamma in ((5, 0.85), (3, 0.0), (2, 0.5)):
        g32 = float(np.float32(gamma))
        assert torch.equal(merge_density(X, sizes, omega, g32),
                           merge_density_plain(X, sizes, omega, g32))
    # dense CRM, slots in h // 2 groups: densities fall on both sides of
    # gamma, so the division and the threshold decide the result
    M = torch.from_numpy(_membership(rng, S, h, groups=max(2, h // 2))).to(dev)
    A = torch.from_numpy(_binary(rng, h, p=0.9)).to(dev)
    X = clique_pair_edges(M, A)
    assert torch.equal(X, clique_pair_edges_plain(M, A))
    sizes = M.sum(dim=1).to(torch.int32)
    for omega, gamma in ((5, 0.85), (3, 0.0), (4, 0.6)):
        g32 = float(np.float32(gamma))
        want = merge_density_plain(X, sizes, omega, g32)
        if h >= 32:
            assert (want >= 0).any() and (want < 0).any()
        assert torch.equal(merge_density(X, sizes, omega, g32), want)
    torch.cuda.synchronize()


#: merge_density's slot counts: S 1, odd S, S 74 (S % 4 == 2: every other
#: row unaligned), catalog-10k's S 2048 and S 2050 (a ragged column tile)
MERGE_SLOTS = [1, 3, 74, 2048, 2050]


@pytest.mark.parametrize("S", MERGE_SLOTS)
def test_merge_density_modes_equal_plain(cuda_device, S):
    """merge_density unmasked and at every act count edge case, bitwise
    against its plain version, twice with the same bits, one launch a
    call; and on X and sizes one element (4 bytes) into their storage, so
    no row of X is 16-byte aligned."""
    X, sizes = kernel_bench.merge_inputs(S, cuda_device, seed=S)
    ks = [None, *sorted({0, 1, 2, S // 3, S - 1, S} & set(range(S + 1)))]
    for omega, gamma in ((5, 0.85), (3, 0.0), (4, 0.6)):
        g32 = float(np.float32(gamma))
        for k in ks:
            n0 = merge_density.launches
            got = merge_density(X, sizes, omega, g32, n_act=k)
            again = merge_density(X, sizes, omega, g32, n_act=k)
            assert merge_density.launches == n0 + 2
            want = merge_density_plain(X, sizes, omega, g32, n_act=k)
            assert torch.equal(got, again), (omega, k)
            assert torch.equal(got, want), (omega, k)
            if S >= 74 and (k is None or k >= S // 3):
                # both sides of the gate and of gamma
                assert (want >= 0).any() and (want == -1).any()
    xb = torch.empty(S * S + 1, dtype=torch.float32, device=cuda_device)
    sb = torch.empty(S + 1, dtype=torch.int32, device=cuda_device)
    Xo, so = xb[1:].view(S, S), sb[1:]
    Xo.copy_(X)
    so.copy_(sizes)
    assert Xo.is_contiguous() and Xo.data_ptr() % 16 == 4
    for k in ks:
        assert torch.equal(merge_density(Xo, so, 5, float(np.float32(0.85)),
                                         n_act=k),
                           merge_density_plain(X, sizes, 5,
                                               float(np.float32(0.85)),
                                               n_act=k)), k
    torch.cuda.synchronize()


def test_merge_density_refuses_bad_operands(cuda_device):
    """The wrapper raises, and launches nothing, on an act count outside
    [0, S], a wrong dtype or a non-contiguous X."""
    X, sizes = kernel_bench.merge_inputs(8, cuda_device)
    wide = torch.zeros((8, 9), dtype=torch.float32, device=cuda_device)
    n0 = merge_density.launches
    for bad in (-1, 9):
        with pytest.raises(ValueError, match="n_act"):
            merge_density(X, sizes, 5, 0.85, n_act=bad)
    with pytest.raises(ValueError, match="float32"):
        merge_density(X.double(), sizes, 5, 0.85)
    with pytest.raises(ValueError, match="int32"):
        merge_density(X, sizes.long(), 5, 0.85)
    with pytest.raises(ValueError, match="contiguous"):
        merge_density(wide[:, :8], sizes, 5, 0.85, n_act=4)
    with pytest.raises(ValueError, match="contiguous"):
        merge_density(X.T, sizes, 5, 0.85)
    assert merge_density.launches == n0


@pytest.mark.parametrize("name", ["crm_update", "clique_pair_edges"])
def test_sparse_kernels_worst_cases(cuda_device, name):
    """crm_update and clique_pair_edges on the inputs their sparse designs
    could get wrong (dense, all-one, all-zero and strided rows of H at h 1
    to 1024, ragged row counts; M with slots in several groups, empty
    rows, S 1, h 1): two calls give the same bits, equal to the plain
    version's."""
    kern, plain = {"crm_update": (crm_update, crm_update_plain),
                   "clique_pair_edges": (clique_pair_edges,
                                         clique_pair_edges_plain)}[name]
    cases = [c for c in worst_cases(cuda_device) if c[0] == name]
    assert len(cases) >= 7
    for _, label, args in cases:
        n0 = kern.launches
        got, again = kern(*args), kern(*args)
        assert kern.launches == n0 + 2
        assert torch.equal(got, again), label
        assert torch.equal(got, plain(*args)), label
    torch.cuda.synchronize()


def test_replay_on_card_equals_cpu(cuda_device):
    """A small AKPC replay on the card (kernels) equals the CPU replay
    (plain versions), which the CPU tests hold against the numpy engine."""
    trace = synth_trace(SynthConfig(
        kind="spotify", n_items=2000, n_servers=20, n_requests=6000,
        t_max=6.0, bundle_cover=1.0, bundle_zipf=0.7, seed=1))

    def policy():
        return get_policy("akpc", params=CostParams(), t_cg=0.5,
                          top_frac=0.1)

    for fn in KERNELS.values():
        fn.launches = 0
    gpu = run_policy(policy(), trace)
    assert all(KERNELS[k].launches > 0 for k in CGM_KERNELS)
    cpu = run_policy(policy(), trace, device="cpu")
    assert np.array_equal(gpu.state.partition.clique_of,
                          cpu.state.partition.clique_of)
    assert np.array_equal(gpu.state.E, cpu.state.E)
    assert np.array_equal(gpu.state.anchor, cpu.state.anchor)
    assert gpu.costs.n_misses == cpu.costs.n_misses
    assert np.isclose(gpu.total, cpu.total, rtol=1e-9, atol=0.0)


#: scan lengths: one position, odd ones, a tile (8192) and one either
#: side, two tiles and one, and a lane of many tiles
SCAN_LENGTHS = [1, 7, 8191, 8192, 8193, 16_385, 100_000]


@pytest.mark.parametrize("starts", ["all", "first", "0.01", "0.5"])
@pytest.mark.parametrize("L", SCAN_LENGTHS)
def test_scan_kernels_equal_plain(cuda_device, L, starts):
    """Both scans bitwise against their plain versions: ties everywhere,
    -inf entries, segments from one position to the whole stream."""
    rng = np.random.default_rng(L)
    v = rng.integers(0, 4, size=L).astype(np.float64)
    v[rng.random(L) < 0.1] = -np.inf
    if starts == "all":
        s = np.ones(L, bool)
    elif starts == "first":
        s = np.zeros(L, bool)
        s[0] = True
    else:
        s = rng.random(L) < float(starts)
    tv = torch.from_numpy(v).to(cuda_device)
    ts = torch.from_numpy(s).to(cuda_device)
    n0, n1 = seg_running_max.launches, seg_running_argmax.launches
    assert torch.equal(seg_running_max(tv, ts), seg_running_max_plain(tv, ts))
    got, want = seg_running_argmax(tv, ts), seg_running_argmax_plain(tv, ts)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int32
    assert (seg_running_max.launches, seg_running_argmax.launches) == \
        (n0 + 1, n1 + 1)
    # the same values one element into a buffer: a misaligned row
    buf = torch.empty(L + 1, dtype=torch.float64, device=cuda_device)
    tv1 = buf[1:]
    tv1.copy_(tv)
    assert torch.equal(seg_running_max(tv1, ts), seg_running_max_plain(tv, ts))
    got = seg_running_argmax(tv1, ts)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


@pytest.mark.parametrize("starts", ["all", "first", "0.01", "0.5"])
@pytest.mark.parametrize("L", SCAN_LENGTHS)
def test_scan_step_equals_plain(cuda_device, L, starts):
    """``seg_scan_step`` (both scans of a replay step in one launch, the
    operands formed in the kernel) bitwise against its plain chain, twice
    in a row; one launch a call."""
    rng = np.random.default_rng([L, len(starts)])
    args = kernel_bench.scan_step_inputs(rng, 1, L, starts, 600, cuda_device)
    n0 = seg_scan_step.launches
    got, again = seg_scan_step(*args), seg_scan_step(*args)
    want = seg_scan_step_plain(*args)
    assert seg_scan_step.launches == n0 + 2
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert got[1].dtype == torch.int64
    torch.cuda.synchronize()


@pytest.mark.parametrize("S,L,m", [(1, 9, 600), (3, 7, 600), (8, 8193, 600),
                                   (64, 1000, 150), (5, 16_385, 5000),
                                   (2, 8192, 4097)])
def test_lane_scan_step_equals_plain(cuda_device, S, L, m):
    """``seg_scan_step`` over S lanes (odd L puts lane rows off 16-byte
    alignment; m over 4096 reads dt through L2, not shared memory)."""
    rng = np.random.default_rng([S, L, m])
    args = kernel_bench.scan_step_inputs(rng, S, L, "0.01", m, cuda_device)
    got = seg_scan_step(*args)
    want = seg_scan_step_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()


@pytest.mark.parametrize("offsets", [(1, 0, 0), (0, 1, 3), (1, 1, 1)])
def test_scan_step_misaligned_inputs(cuda_device, offsets):
    """``seg_scan_step`` on times, ids and flags that start 1-3 elements
    into their buffers (rows at other alignments than the outputs')."""
    rng = np.random.default_rng(sum(offsets))
    args = list(kernel_bench.scan_step_inputs(rng, 3, 8193, "0.5", 600,
                                              cuda_device))
    for i, a in enumerate(args[:6]):
        off = offsets[i % 3]
        buf = torch.empty(a.numel() + off, dtype=a.dtype, device=cuda_device)
        args[i] = buf[off:]
        args[i].copy_(a)
    got = seg_scan_step(*args)
    want = seg_scan_step_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    torch.cuda.synchronize()


def test_scan_step_in_cuda_graph_equals_eager(cuda_device):
    """A CUDA graph of ``seg_scan_step`` (as ``cuda_graph_time`` captures
    it) gives the eager call's bits."""
    rng = np.random.default_rng(3)
    args = kernel_bench.scan_step_inputs(rng, 2, 8192, "0.01", 600,
                                         cuda_device)
    want = seg_scan_step(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        seg_scan_step(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = seg_scan_step(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.parametrize("G,S,L,m", [(2, 2, 9, 600), (3, 7, 8193, 600),
                                     (3, 3, 16_385, 150), (4, 9, 7, 5000)])
def test_scan_step_rows_equal_plain(cuda_device, G, S, L, m):
    """``seg_scan_step`` with per-lane event rows ((G, L) rows, lane s on
    row s % G; odd L puts rows off 16-byte alignment) bitwise against its
    plain version twice in a row, one launch a call, and against the
    shared-form kernel on each lane's row."""
    rng = np.random.default_rng([G, S, L, m])
    args = kernel_bench.scan_step_rows_inputs(rng, G, S, L, "0.01", m,
                                              cuda_device)
    n0 = seg_scan_step.launches
    got, again = seg_scan_step(*args), seg_scan_step(*args)
    assert seg_scan_step.launches == n0 + 2
    want = seg_scan_step_plain(*args)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, c) and torch.equal(b, c)
    dt, rows = args[6], args[7].tolist()
    for lane, r in enumerate(rows):
        one = seg_scan_step(*(a[r] for a in args[:6]),
                            dt[lane:lane + 1].contiguous())
        for a, b in zip(got, one):
            assert torch.equal(a[lane], b[0])
    torch.cuda.synchronize()


@pytest.mark.parametrize("S,L", [(1, 9), (3, 8193), (4, 16_385)])
def test_scan_kernels_lane_starts_equal_plain(cuda_device, S, L):
    """The standalone scans over (S, L) starts, a start mask a lane."""
    rng = np.random.default_rng([S, L, 7])
    v = torch.from_numpy(rng.integers(0, 4, size=(S, L)).astype(
        np.float64)).to(cuda_device)
    st = torch.from_numpy(rng.random((S, L)) < 0.05).to(cuda_device)
    assert torch.equal(seg_running_max(v, st), seg_running_max_plain(v, st))
    gv, gi = seg_running_argmax(v, st)
    pv, pi = seg_running_argmax_plain(v, st)
    assert torch.equal(gv, pv) and torch.equal(gi, pi)
    torch.cuda.synchronize()


@pytest.mark.parametrize("C,omega,d,R,dtype", [
    (4096, 5, 128, 4096, torch.float32), (4096, 5, 128, 300, torch.float64),
    (60, 1, 1, 9999, torch.int32), (33, 3, 7, 64, torch.int32),
    (5, 1, 3, 1, torch.float32)])
def test_packed_lookup_equals_plain(cuda_device, C, omega, d, R, dtype):
    rng = np.random.default_rng(C + R)
    table = torch.from_numpy(rng.standard_normal((C, omega, d)) * 100).to(
        dtype).to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, C, size=R).astype(np.int32)).to(
        cuda_device)
    n0 = packed_lookup.launches
    assert torch.equal(packed_lookup(table, ids),
                       packed_lookup_plain(table, ids))
    assert packed_lookup.launches == n0 + 1
    with pytest.raises(IndexError):
        packed_lookup(table, torch.tensor([0, C], dtype=torch.int32,
                                          device=cuda_device))
    torch.cuda.synchronize()


@pytest.mark.parametrize("h,S", [(6, 5), (37, 20), (1000, 700)])
def test_cgm_kernels_at_host_path_shapes(cuda_device, h, S):
    """The host clique generation hands crm_update a contiguous (B, h)
    incidence and clique_pair_edges k <= h groups over h hot slots."""
    rng = np.random.default_rng(h)
    H = torch.from_numpy(_incidence(rng, 25_000, h, d=3)).to(cuda_device)
    assert torch.equal(crm_update(H), crm_update_plain(H))
    M = torch.from_numpy(_membership(rng, S, h)).to(cuda_device)
    A = torch.from_numpy(_binary(rng, h)).to(cuda_device)
    assert torch.equal(clique_pair_edges(M, A), clique_pair_edges_plain(M, A))
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["akpc", "ttl"])
def test_host_schedule_replay_on_card_equals_cpu(cuda_device, name):
    """A heterogeneous-price (per-server dt) replay on the card equals the
    CPU replay of the same short trace; the scan and lookup kernels (and,
    for akpc, the host clique generation's kernels) launch."""
    trace = synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=40, n_requests=8000,
        t_max=4.0, bundle_cover=1.0, bundle_zipf=0.7, seed=2,
        size_dist="lognormal"))
    env = CacheEnvironment.skewed(trace.n, trace.m, CostParams(),
                                  price_sigma=1.0, seed=1)
    kw = dict(t_cg=0.5) if name == "ttl" else dict(t_cg=0.5, top_frac=0.1)

    def policy():
        return get_policy(name, params=CostParams(), env=env,
                          cost_model="heterogeneous", **kw)

    for fn in KERNELS.values():
        fn.launches = 0
    gpu = run_policy(policy(), trace)
    want = ["seg_scan_step", "packed_lookup"]
    if name == "akpc":
        want += ["crm_update", "clique_pair_edges"]
    assert all(KERNELS[k].launches > 0 for k in want)
    assert gpu.loop_stats["path"] == "host_schedule"
    # one launch of both scans a live step, no standalone scan
    assert seg_scan_step.launches == gpu.loop_stats["steps"]
    assert seg_running_max.launches == seg_running_argmax.launches == 0
    cpu = run_policy(policy(), trace, device="cpu")
    assert np.array_equal(gpu.state.partition.clique_of,
                          cpu.state.partition.clique_of)
    assert np.array_equal(gpu.state.E, cpu.state.E)
    assert np.array_equal(gpu.state.anchor, cpu.state.anchor)
    assert gpu.costs.n_misses == cpu.costs.n_misses
    assert gpu.costs.n_hits == cpu.costs.n_hits
    assert np.isclose(gpu.total, cpu.total, rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.float64])
@pytest.mark.parametrize("d,R", [(1, 9999), (3, 1), (255, 64), (256, 64),
                                 (256, 4096)])
def test_unpacked_lookup_equals_plain(cuda_device, d, R, dtype):
    """The unpacked gather bitwise against its plain version and against
    the packed gather of the same bytes; ids outside [0, n) raise."""
    rng = np.random.default_rng(d + R)
    C, omega = 128, 5
    table = torch.from_numpy(rng.standard_normal((C, omega, d)) * 100).to(
        dtype).to(cuda_device)
    items = table.reshape(C * omega, d)
    cids = torch.from_numpy(rng.integers(0, C, size=R).astype(np.int32)).to(
        cuda_device)
    iids = (cids[:, None] * omega + torch.arange(
        omega, dtype=torch.int32, device=cuda_device)).to(torch.int32)
    n0 = unpacked_lookup.launches
    got = unpacked_lookup(items, iids)
    assert unpacked_lookup.launches == n0 + 1
    assert torch.equal(got, unpacked_lookup_plain(items, iids))
    assert torch.equal(got, packed_lookup(table, cids))
    rids = torch.from_numpy(rng.integers(0, C * omega, size=(R, 2)).astype(
        np.int32)).to(cuda_device)
    assert torch.equal(unpacked_lookup(items, rids),
                       unpacked_lookup_plain(items, rids))
    for bad in (-1, C * omega):
        with pytest.raises(IndexError):
            unpacked_lookup(items, torch.tensor([[0, bad]], dtype=torch.int32,
                                                device=cuda_device))
    torch.cuda.synchronize()


@pytest.mark.parametrize("S,L", [(1, 9), (1, 8193), (3, 7), (8, 8193),
                                 (64, 1000)])
def test_lane_scans_equal_plain(cuda_device, S, L):
    """The scans' lane form, (S, L) values over one (L,) start vector,
    bitwise against the plain version and the one-lane kernel per lane."""
    rng = np.random.default_rng(S * L)
    v = rng.integers(0, 4, size=(S, L)).astype(np.float64)
    v[rng.random((S, L)) < 0.1] = -np.inf
    s = rng.random(L) < 0.01
    tv = torch.from_numpy(v).to(cuda_device)
    ts = torch.from_numpy(s).to(cuda_device)
    n0 = seg_running_max.launches
    got = seg_running_max(tv, ts)
    assert seg_running_max.launches == n0 + 1
    assert torch.equal(got, seg_running_max_plain(tv, ts))
    gv, gi = seg_running_argmax(tv, ts)
    pv, pi = seg_running_argmax_plain(tv, ts)
    assert torch.equal(gv, pv) and torch.equal(gi, pi)
    for i in range(S):
        lv, li = seg_running_argmax(tv[i].contiguous(), ts)
        assert torch.equal(gv[i], lv) and torch.equal(gi[i], li)
    torch.cuda.synchronize()


def test_laned_sweep_on_card_equals_cpu(cuda_device):
    """A small sweep under per-server dt (two schedules of 3 scenario
    lanes each, one cohort: one scan over 6 lanes) on the card equals the
    same sweep on the CPU, state and costs; the lane scans launch."""
    trace = synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=40, n_requests=6000,
        t_max=4.0, bundle_cover=1.0, bundle_zipf=0.7, seed=2,
        size_dist="lognormal"))
    pts = []
    for alpha in (0.6, 0.8, 1.0):
        params = CostParams(alpha=alpha)
        env = CacheEnvironment.resolve(CacheEnvironment.skewed(
            trace.n, trace.m, params, price_sigma=1.0, seed=1), trace, params)
        for name in ("akpc", "no_packing"):
            kw = dict(params=params, env=env, cost_model="heterogeneous")
            if name == "akpc":
                kw.update(t_cg=0.5, top_frac=0.5)
            pts.append(SweepPoint(name, trace, kw))
    n0, n1 = seg_scan_step.launches, seg_running_max.launches
    eng = SweepEngine()
    gpu = eng.run(pts)
    assert seg_scan_step.launches > n0
    assert seg_running_max.launches == n1
    assert [(g["lanes"], g["schedules"])
            for g in eng.last_stats["groups"]] == [(6, 2)]
    cpu = SweepEngine(device="cpu").run(pts)
    for a, b in zip(gpu, cpu):
        assert np.array_equal(a.state.partition.clique_of,
                              b.state.partition.clique_of)
        assert np.array_equal(a.state.E, b.state.E)
        assert np.array_equal(a.state.anchor, b.state.anchor)
        assert a.costs.n_misses == b.costs.n_misses
        assert np.isclose(a.total, b.total, rtol=1e-9, atol=0.0)


def test_super_group_and_shard_sweep_on_card_equals_cpu(cuda_device):
    """The sweep's device-CGM super-group and its shards on the card: AKPC
    points that differ in theta (the reference's device-CGM super-group,
    the lanes of one laned device clique generation, one schedule) and a
    point over three trace shards (one schedule a shard, the lanes of one
    scan) equal the same sweep on the CPU, state and costs."""
    def trace(seed, n_requests):
        return synth_trace(SynthConfig(
            kind="netflix", n_items=60, n_servers=12, n_requests=n_requests,
            t_max=30.0, bundle_cover=1.0, bundle_zipf=0.7, seed=seed))

    kw = dict(t_cg=0.73, top_frac=1.0)
    tr = trace(3, 3000)
    shards = [trace(s, 1200) for s in (3, 4, 5)]
    pts = [SweepPoint("akpc", tr, dict(params=CostParams(theta=th), **kw))
           for th in (0.1, 0.3)]
    pts.append(SweepPoint("akpc", shards, dict(params=CostParams(), **kw)))
    md0 = merge_density.launches
    eng = SweepEngine()
    gpu = eng.run(pts)
    assert merge_density.launches > md0
    assert eng.last_stats["device_cgm_points"] == 2
    assert eng.last_stats["shard_schedules"] == 3
    assert eng.last_n_schedules == 1 + 3
    (rec,) = eng.last_stats["cgm_groups"]
    assert rec["lanes"] == 2 and rec["windows"] >= 3
    cpu = SweepEngine(device="cpu").run(pts)
    for a, b in zip(gpu, cpu):
        assert np.array_equal(a.state.partition.clique_of,
                              b.state.partition.clique_of)
        assert np.array_equal(a.state.E, b.state.E)
        assert np.array_equal(a.state.anchor, b.state.anchor)
        for f in ("n_requests", "n_misses", "n_hits", "items_transferred"):
            assert getattr(a.costs, f) == getattr(b.costs, f)
        assert np.isclose(a.total, b.total, rtol=1e-9, atol=0.0)
    assert gpu[2].shard_stats["n"] == 3
    np.testing.assert_allclose(gpu[2].shard_stats["totals"],
                               cpu[2].shard_stats["totals"], rtol=1e-9)


def test_hetero_shard_group_is_one_scan_on_card(cuda_device):
    """Two scenarios over three shards under per-server dt: one scan of 6
    lanes, one ``seg_scan_step`` launch (per-lane rows) a live step, and
    the CPU sweep's state and costs."""
    def trace(seed):
        return synth_trace(SynthConfig(
            kind="netflix", n_items=60, n_servers=12, n_requests=1500,
            t_max=30.0, bundle_cover=1.0, bundle_zipf=0.7, seed=seed))

    shards = [trace(s) for s in (3, 4, 5)]
    params = CostParams()
    env = CacheEnvironment.skewed(60, 12, params, price_sigma=0.8,
                                  size_sigma=0.4, seed=1)
    pts = [SweepPoint("akpc", shards, dict(
        params=CostParams(alpha=a), env=env, cost_model="heterogeneous",
        t_cg=0.73, top_frac=1.0)) for a in (0.7, 0.9)]
    n0 = seg_scan_step.launches
    eng = SweepEngine()
    gpu = eng.run(pts)
    (grp,) = eng.last_stats["groups"]
    assert (grp["lanes"], grp["schedules"]) == (6, 3)
    assert seg_scan_step.launches - n0 == grp["steps"] > 0
    cpu = SweepEngine(device="cpu").run(pts)
    for a, b in zip(gpu, cpu):
        assert np.array_equal(a.state.E, b.state.E)
        assert np.array_equal(a.state.anchor, b.state.anchor)
        assert a.costs.n_misses == b.costs.n_misses
        assert np.isclose(a.total, b.total, rtol=1e-9, atol=0.0)
        np.testing.assert_allclose(a.shard_stats["totals"],
                                   b.shard_stats["totals"], rtol=1e-9)


@pytest.mark.parametrize("case", range(len(kernel_bench.LANE_SHAPES) * 4))
def test_laned_cgm_kernels_equal_plain(cuda_device, case):
    """Each laned CGM kernel (lanes 1, 2, 17 and 3 at h 1024; lanes with
    different hot counts, omega, gamma and act counts) gives its laned
    plain version's bits twice in a row, one launch a call."""
    name, label, args = kernel_bench.lane_cases(cuda_device)[case]
    kern = KERNELS[name]
    if name == "merge_density":
        def call():
            return kern(*args[:4], n_act=args[4], act_max=args[5])
        want = merge_density_lanes_plain(*args[:5])
    else:
        def call():
            return kern(*args)
        want = {"crm_update": crm_update_plain,
                "clique_pair_edges": clique_pair_edges_plain}[name](*args)
    n0 = kern.launches
    got, again = call(), call()
    torch.cuda.synchronize()
    assert kern.launches == n0 + 2
    assert torch.equal(got, want) and torch.equal(again, want), label


@pytest.mark.parametrize("case", range(len(kernel_bench.WIDE_ROWS)))
def test_sliced_lookup_on_multi_mb_rows(cuda_device, case):
    """The ``sliced`` path on rows longer than a 6 MB slice (the expert
    cache's 23.6 MB clique rows, two and three with a repeat) and a
    16-byte unit either side of one slice: each row spread over the grid,
    the plain gather's bits."""
    label, table, ids = list(kernel_bench.wide_row_cases(cuda_device))[case]
    want = packed_lookup_plain(table, ids)
    got = packed_lookup(table, ids)
    assert packed_lookup.last_path == "sliced"
    torch.cuda.synchronize()
    assert torch.equal(got, want), label


def test_super_group_lanes_on_card_equal_serial_card_runs(cuda_device):
    """A mixed super-group (omega 2 / 3 / 5, a gamma outside the pruning
    regime, top_frac 0.5 and 1.0) as one laned clique generation on the
    card: every lane equals its serial device-CGM run on the card, state
    and costs, and the three CGM kernels launch once a window."""
    tr = synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=12, n_requests=3000,
        t_max=30.0, bundle_cover=1.0, bundle_zipf=0.7, seed=3))
    knobs = [(0.1, 0.6, 2, 0.5), (0.3, 0.9, 3, 1.0), (0.2, 0.6, 5, 0.5)]
    kws = [dict(params=CostParams(theta=th, gamma=g, omega=om), t_cg=0.73,
                top_frac=tf) for th, g, om, tf in knobs]
    eng = SweepEngine()
    n0 = {k: KERNELS[k].launches for k in CGM_KERNELS}
    got = eng.run([SweepPoint("akpc", tr, kw) for kw in kws])
    (rec,) = eng.last_stats["cgm_groups"]
    for k in CGM_KERNELS:
        assert KERNELS[k].launches - n0[k] == rec["windows"], k
    assert eng.last_n_schedules == 1 and rec["full_merge"]
    for kw, a in zip(kws, got):
        b = run_policy_torch(get_policy("akpc", **kw), tr)
        assert np.array_equal(a.state.partition.clique_of,
                              b.state.partition.clique_of)
        assert np.array_equal(a.state.E, b.state.E)
        assert np.array_equal(a.state.anchor, b.state.anchor)
        assert a.costs.n_misses == b.costs.n_misses
        assert np.isclose(a.total, b.total, rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("dtype", kernel_bench.LOOKUP_DTYPES)
@pytest.mark.parametrize("R", kernel_bench.LOOKUP_REQUESTS)
@pytest.mark.parametrize("row", kernel_bench.LOOKUP_ROWS,
                         ids=[r[0] for r in kernel_bench.LOOKUP_ROWS])
def test_lookup_paths_equal_plain(cuda_device, row, R, dtype):
    """Both lookups on each path of their copy engine (narrow 4- to
    16-byte rows, vector 1 KB rows of a 1 MB table, sliced 5 KB rows of a
    15 MB one, ragged 5 KB + 4 byte rows and unaligned tables or ids) take
    the expected path and give the plain version's bits twice in a row."""
    case = kernel_bench.lookup_case(row, R, dtype, cuda_device)
    n0, u0 = packed_lookup.launches, unpacked_lookup.launches
    report = kernel_bench.check_lookup_case(case)
    assert all(r["equal"] for r in report)
    assert [r["path"] for r in report] == [row[2], row[2]]
    assert packed_lookup.launches == n0 + 2
    assert unpacked_lookup.launches == u0 + 2


@pytest.mark.parametrize("row", [kernel_bench.LOOKUP_ROWS[i]
                                 for i in (0, 2, 4, 5, 6)],
                         ids=["4-byte", "12-byte", "1 KB", "5 KB", "5 KB + 4"])
def test_lookup_in_cuda_graph_equals_eager(cuda_device, row):
    """A lookup captured in a CUDA graph equals the eager call, and a
    replay after the ids change in place gathers the new rows."""
    case = kernel_bench.lookup_case(row, 777, torch.float32, cuda_device)
    table, cids = case["table"], case["cids"].clone()
    items, iids = case["items"], cids.view(-1, 1)
    eager = (packed_lookup(table, cids), unpacked_lookup(items, iids))
    assert (packed_lookup.last_path, unpacked_lookup.last_path) == \
        (row[2], row[2])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        packed_lookup(table, cids, ids_checked=True)
        unpacked_lookup(items, iids, ids_checked=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = (packed_lookup(table, cids, ids_checked=True),
               unpacked_lookup(items, iids, ids_checked=True))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], eager[0]) and torch.equal(got[1], eager[1])
    cids.copy_(torch.flip(cids, (0,)))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], packed_lookup_plain(table, cids))
    assert torch.equal(got[1], unpacked_lookup_plain(items, iids))


def test_clique_lookup_on_card(cuda_device):
    """``clique_lookup`` and ``CliqueLookup`` with no device run on the
    card: the answers of the CPU, the table uploaded once while it stays
    the same and again after a change in place, -1 pads kept."""
    rng = np.random.default_rng(5)
    clique_of = rng.permutation(10_000).astype(np.int64)
    items = rng.integers(-1, 10_000, size=(4001, 5))
    want = clique_lookup(clique_of, items, device="cpu")
    assert np.array_equal(clique_lookup(clique_of, items), want)
    look = CliqueLookup()
    assert look.device.type == "cuda"
    n0 = packed_lookup.launches
    for _ in range(3):
        assert np.array_equal(look(clique_of, items), want)
    assert packed_lookup.launches == n0 + 3
    assert packed_lookup.last_path == "narrow"
    assert look.table_uploads == 1
    clique_of[items[0, 0]] = 77_777
    got = look(clique_of, items)
    assert look.table_uploads == 2
    assert np.array_equal(got, clique_lookup(clique_of, items, device="cpu"))
    assert (got[items < 0] == -1).all()
    small = look(clique_of, items[:3])
    assert np.array_equal(small, got[:3])


# ---------------------------------------------------------------------------
# the live serving engine on the card
# ---------------------------------------------------------------------------
def _serve_case(config):
    """(trace, policy factory, env) of a live-engine card test: ``akpc``
    at a uniform dt (the device clique generation), or ``akpc`` /
    ``no_packing`` under per-server prices (the host schedule)."""
    hetero = config != "akpc-table1"
    trace = synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=40, n_requests=12_000,
        t_max=6.0, bundle_cover=1.0, bundle_zipf=0.7, seed=4,
        size_dist="lognormal" if hetero else "unit"))
    env = (CacheEnvironment.resolve(CacheEnvironment.skewed(
        trace.n, trace.m, CostParams(), price_sigma=1.0, seed=1), trace,
        CostParams()) if hetero else None)
    name = config.split("-")[0]
    kw = {} if name == "no_packing" else dict(t_cg=0.4, top_frac=0.5)

    def policy():
        return get_policy(name, params=CostParams(), env=env,
                          cost_model="heterogeneous" if hetero else "table1",
                          **kw)

    return trace, policy, env


def _serve(eng, trace, slice_n=97):
    """Stream the trace in arrival slices; the ring never holds more than
    ``ring`` chunks."""
    for lo in range(0, trace.n_requests, slice_n):
        hi = lo + slice_n
        eng.submit(trace.items[lo:hi], trace.servers[lo:hi],
                   trace.times[lo:hi])
        assert eng.in_flight <= eng.ring
    eng.drain()
    assert eng.in_flight == 0
    return eng


def _same_serve_state(a, b):
    sa, sb = a.session.engine.state, b.session.engine.state
    assert np.array_equal(sa.partition.clique_of, sb.partition.clique_of)
    assert np.array_equal(sa.E, sb.E)
    assert np.array_equal(sa.anchor, sb.anchor)


@pytest.mark.parametrize("config", ["akpc-table1", "akpc-hetero",
                                    "no_packing-hetero"])
def test_live_engine_on_card_equals_plain_and_cpu(cuda_device, config):
    """The live engine on the card, with its kernels, equals the same run
    with the plain versions on the card (bit for bit, costs too), which
    equals the CPU run (state bit for bit, costs at 1e-9); the path's
    kernels launch, and only in the kernel run."""
    trace, policy, env = _serve_case(config)

    def engine(**kw):
        return LiveServingEngine(policy(), trace.n, trace.m, env=env,
                                 chunk_size=1024, ring=3, **kw)

    for fn in KERNELS.values():
        fn.launches = 0
    card = _serve(engine(), trace)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    if config == "akpc-table1":
        assert card._cgm
        want = CGM_KERNELS
        assert launches["merge_density"] == card.policy.n_windows
    else:
        assert not card._cgm
        want = ("seg_scan_step", "packed_lookup")
        if config == "akpc-hetero":
            want += ("crm_update", "clique_pair_edges")
    assert all(launches[k] > 0 for k in want), launches
    plain = _serve(engine(use_kernels=False), trace)
    assert {k: fn.launches for k, fn in KERNELS.items()} == launches
    _same_serve_state(card, plain)
    assert card.costs.as_dict() == plain.costs.as_dict()
    cpu = _serve(engine(device="cpu"), trace)
    _same_serve_state(card, cpu)
    a, b = card.costs.as_dict(), cpu.costs.as_dict()
    for key in ("n_requests", "n_item_requests", "n_misses", "n_hits",
                "items_transferred"):
        assert a[key] == b[key]
    for key in ("transfer", "caching", "keepalive_rent", "total"):
        assert np.isclose(a[key], b[key], rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("config", ["akpc-table1", "no_packing-hetero"])
def test_live_ring_buffers_survive_a_slow_stream(cuda_device, config,
                                                 monkeypatch):
    """A stream slowed on the card (``torch.cuda._sleep`` before each
    chunk's uploads) lets the host run ``ring`` chunks ahead: a pinned
    buffer refilled before its copy landed would change the result.  The
    slowed run equals the plain-speed one bit for bit, its submits waited
    on the ring (on the host-schedule path), and no more than ``ring``
    chunks were ever in flight."""
    trace, policy, env = _serve_case(config)

    def run():
        return _serve(LiveServingEngine(policy(), trace.n, trace.m, env=env,
                                        chunk_size=256, ring=2), trace)

    fast = run()
    stage = live_module.LiveServingEngine._stage

    def slow_stage(self, arrays):
        torch.cuda._sleep(20_000_000)
        return stage(self, arrays)

    monkeypatch.setattr(live_module.LiveServingEngine, "_stage", slow_stage)
    slow = run()
    if not slow._cgm:
        # the device CGM's loops wait for the card inside a chunk; the
        # host schedule's dispatch does not, so there the ring fills
        assert slow.ring_waits > 0
    _same_serve_state(fast, slow)
    assert fast.costs.as_dict() == slow.costs.as_dict()


# ---------------------------------------------------------------------------
# the learned policy's trainer and the two cache consumers
# ---------------------------------------------------------------------------
#: the trainer's bar, card against CPU: each leaf within this share of its
#: largest magnitude (tests/test_torch_learned.py's bar against the
#: reference)
TRAIN_LEAF_RTOL = 1e-5


def _stress(seed, n_requests=2500):
    return fig11.stress_trace("regime_shift", seed, n_requests)


@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
def test_learned_trainer_on_card_equals_cpu(cuda_device, cost_model):
    """``train_policy`` on the card against the CPU from the same inputs:
    every leaf within the bar; the step loop itself makes no host sync
    (sync debug mode "error" raises on one)."""
    params = CostParams(rho=4.0)
    env = fig11.env_for(cost_model, params)
    tr = _stress(200)
    t_cg = fig11.t_cg_for(tr, params, env=env, cost_model=cost_model)
    kw = dict(env=env, t_cg=t_cg, params=params, cost_model=cost_model)
    card = train_policy(tr, **kw)
    cpu = train_policy(tr, device="cpu", **kw)
    for (path, a), (_, b) in zip(tree_leaves(cpu.w), tree_leaves(card.w)):
        assert np.abs(a - b).max() <= TRAIN_LEAF_RTOL * np.abs(a).max(), path
    assert np.array_equal(card.mu, cpu.mu) and np.array_equal(card.sd, cpu.sd)

    lp = warm_params(1.0, 1.0, t_cg)
    X = torch.randn((512, lp.n_features), dtype=torch.float64,
                    device=cuda_device)
    y = (torch.rand(512, device=cuda_device) < 0.5).to(torch.float64)
    idx = torch.randint(0, 512, (20, 64), dtype=torch.int32,
                        device=cuda_device)
    scorer = Scorer(lp, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses, final = train_steps(scorer, X, y, torch.ones_like(y), idx,
                                    adamw_config(TrainConfig(steps=20)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(losses).all() and torch.isfinite(final)


@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
def test_learned_serving_on_card_equals_cpu(cuda_device, cost_model):
    """A trained scorer served through ``run_policy`` on the card: kernel
    run == plain run bit for bit, and == the CPU run (state bit for bit,
    costs at 1e-9); under per-server dt one ``seg_scan_step`` a step."""
    params = CostParams(rho=4.0)
    env = fig11.env_for(cost_model, params)
    tr = _stress(200)
    t_cg = fig11.t_cg_for(tr, params, env=env, cost_model=cost_model)
    lp = train_policy(tr, env=env, t_cg=t_cg, params=params,
                      cost_model=cost_model, device="cpu")
    ev = _stress(101, 20_000)

    def pol():
        return get_policy("learned", params=params, env=env,
                          cost_model=cost_model, t_cg=t_cg, learned=lp)

    for fn in KERNELS.values():
        fn.launches = 0
    card = run_policy(pol(), ev)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    assert launches["packed_lookup"] > 0
    want = card.loop_stats["steps"] if cost_model == "heterogeneous" else 0
    assert launches["seg_scan_step"] == want
    plain = run_policy_torch(pol(), ev, use_kernels=False)
    assert {k: fn.launches for k, fn in KERNELS.items()} == launches
    assert card.costs.as_dict() == plain.costs.as_dict()
    cpu = run_policy(pol(), ev, device="cpu")
    for a, b in ((card.state, plain.state), (card.state, cpu.state)):
        assert np.array_equal(a.E, b.E) and np.array_equal(a.anchor,
                                                           b.anchor)
    a, b = card.costs.as_dict(), cpu.costs.as_dict()
    for key in ("n_requests", "n_item_requests", "n_misses", "n_hits",
                "items_transferred"):
        assert a[key] == b[key]
    for key in ("transfer", "caching", "keepalive_rent", "total"):
        assert np.isclose(a[key], b[key], rtol=1e-9, atol=0.0)


def test_consumers_pipeline_live_on_card_equals_cpu(cuda_device):
    """``PackedDataPipeline``'s live backend on the card against the CPU:
    the same batches, costs at 1e-9, state bit for bit."""
    def run(device):
        p = PackedDataPipeline(ShardStore(n_shards=64, shard_tokens=256,
                                          vocab=100), batch_rows=8,
                               seq_len=32, t_cg=16.0, backend="live",
                               device=device)
        out = [next(p) for _ in range(60)]
        p.cache.drain()
        return p, out

    (pc, oc), (pg, og) = run("cpu"), run(cuda_device)
    assert all(np.array_equal(a, b) for a, b in zip(oc, og))
    a, b = pc.cache.costs.as_dict(), pg.cache.costs.as_dict()
    for key in ("transfer", "caching", "keepalive_rent", "total"):
        assert np.isclose(a[key], b[key], rtol=1e-9, atol=0.0)
    assert a["n_misses"] == b["n_misses"] and a["n_hits"] == b["n_hits"]
    sa, sb = pc.cache.session.engine.state, pg.cache.session.engine.state
    assert np.array_equal(sa.E, sb.E)


def test_consumers_expert_cache_live_on_card_equals_cpu(cuda_device):
    """``ExpertCacheManager``'s live backend on the card against the CPU:
    equal ``stats()``; a card snapshot restores into a CPU session manager
    that finishes with equal totals."""
    rng = np.random.default_rng(7)
    obs = [(rng.integers(0, 16, size=(32, 2)), int(rng.integers(0, 4)))
           for _ in range(200)]

    def mgr(device, backend="live"):
        return ExpertCacheManager(n_experts=16, n_hosts=4, t_cg=8.0,
                                  backend=backend, device=device)

    card, cpu = mgr(cuda_device), mgr("cpu")
    for topk, host in obs[:100]:
        card.observe(topk, host=host)
        cpu.observe(topk, host=host)
    standby = mgr("cpu", "session")
    standby.restore(card.snapshot())
    for m in (card, cpu, standby):
        for topk, host in obs[100:]:
            m.observe(topk, host=host)
    sc, su, ss = card.stats(), cpu.stats(), standby.stats()
    for other in (su, ss):
        assert np.isclose(sc.akpc_total, other.akpc_total, rtol=1e-9)
        assert sc.nopack_total == other.nopack_total
        assert sc.cliques == other.cliques


def test_competitive_checks_on_card_equal_cpu(cuda_device):
    """The Thm-2 adversary on the card realises the corrected bound, and
    the per-request checks (a batch-1 replay with the per-step record)
    give the CPU's values under table1 and heterogeneous pricing."""
    from repro_torch.core import (
        CliquePartition,
        adversarial_trace,
        generalized_per_request_ratio_check,
        per_request_ratio_check,
        replay_adversary,
    )
    from repro_torch.traces import paper_trace

    params = CostParams(omega=5)
    setup = adversarial_trace(S=2, omega=5, n_phases=7, params=params)
    akpc, opt, bound = replay_adversary(setup, params)
    assert np.isclose(akpc / opt, bound, rtol=1e-12, atol=0.0)
    tr = paper_trace("netflix", 600, seed=4)
    part = CliquePartition.from_cliques(
        60, [tuple(range(i, i + 5)) for i in range(0, 60, 5)])
    got = per_request_ratio_check(tr, part, CostParams())
    assert np.isclose(got, per_request_ratio_check(
        tr, part, CostParams(), device="cpu"), rtol=1e-12, atol=0.0)
    assert got <= 1.0
    env = CacheEnvironment.skewed(60, tr.m, CostParams(), price_sigma=0.6,
                                  size_sigma=0.3, seed=5)
    kw = dict(env=env, cost_model="heterogeneous")
    got = generalized_per_request_ratio_check(tr, part, CostParams(), **kw)
    assert np.isclose(got, generalized_per_request_ratio_check(
        tr, part, CostParams(), device="cpu", **kw), rtol=1e-12, atol=0.0)
    assert got <= 1.0


@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
def test_paper_literal_on_card_equals_cpu(cuda_device, cost_model):
    """``cost_mode="paper_literal"``: AKPC on the device CGM (table1) and
    on the host schedule (heterogeneous) gives the CPU's state and
    costs."""
    from repro_torch.bench.common import t_cg_for
    from repro_torch.traces import paper_trace

    tr = paper_trace("spotify", 6000, seed=3)
    params = CostParams(cost_mode="paper_literal")
    env = None
    if cost_model == "heterogeneous":
        env = CacheEnvironment.skewed(tr.n, tr.m, params, price_sigma=0.5,
                                      size_sigma=0.5, seed=3)
    kw = dict(params=params, env=env, cost_model=cost_model, top_frac=1.0,
              t_cg=t_cg_for(tr, params, env=env, cost_model=cost_model))
    gpu = run_policy(get_policy("akpc", **kw), tr)
    cpu = run_policy(get_policy("akpc", **kw), tr, device="cpu")
    assert np.array_equal(gpu.state.partition.clique_of,
                          cpu.state.partition.clique_of)
    assert np.array_equal(gpu.state.E, cpu.state.E)
    assert np.array_equal(gpu.state.anchor, cpu.state.anchor)
    assert gpu.costs.n_misses == cpu.costs.n_misses
    assert np.isclose(gpu.total, cpu.total, rtol=1e-9, atol=0.0)


def test_run_schedules_on_card_makes_no_sync(cuda_device):
    """``run_schedules`` over three shard schedules (per-server dt, lanes
    on rows 0, 2, 1, 2) under sync debug mode "error": no host sync in
    the loop, one ``seg_scan_step`` launch a live step, and the CPU's
    state and costs."""
    from repro_torch.core import get_cost_model
    from repro_torch.core.cliques import CliquePartition
    from repro_torch.core.replay import (
        cost_spec,
        fresh_state_arrays,
        run_schedules,
    )
    from repro_torch.core.schedule import (
        build_schedule,
        pad_schedule,
        schedule_dims,
    )

    params = CostParams()
    env = CacheEnvironment.skewed(60, 12, params, price_sigma=0.8,
                                  size_sigma=0.4, seed=1)
    scheds = []
    for seed in (3, 4, 5):
        tr = synth_trace(SynthConfig(
            kind="netflix", n_items=60, n_servers=12, n_requests=3000,
            t_max=30.0, bundle_cover=1.0, bundle_zipf=0.7, seed=seed))
        pol = get_policy("akpc", params=params, env=env, t_cg=0.73,
                         top_frac=1.0, cost_model="heterogeneous")
        pol.bind(tr.n, tr.m)
        model = get_cost_model("heterogeneous", env)
        scheds.append(build_schedule(CliquePartition.singletons(tr.n), tr,
                                     pol.on_window, pol.t_cg, model=model,
                                     env=env))
    spec0, statics = cost_spec(model, env)
    dims = {k: max(schedule_dims(s)[k] for s in scheds)
            for k in schedule_dims(scheds[0])}
    scheds = [pad_schedule(s, dims) for s in scheds]
    rows = [0, 2, 1, 2]
    spec = {k: np.stack([spec0[k]] * len(rows)) for k in spec0}
    E0, a0 = fresh_state_arrays(60, 12)
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        E = torch.from_numpy(np.stack([E0] * len(rows))).to(dev)
        A = torch.from_numpy(np.stack([a0] * len(rows))).to(dev)
        stats: dict = {}
        n0 = seg_scan_step.launches
        outs[dev.type] = run_schedules(
            scheds, spec, statics, E, A, rows=rows, stats=stats,
            check_syncs=dev.type == "cuda")
        if dev.type == "cuda":
            assert seg_scan_step.launches - n0 == stats["steps"] > 0
    (Eg, Ag, accg), (Ec, Ac, accc) = outs["cuda"], outs["cpu"]
    assert torch.equal(Eg[:, :60].cpu(), Ec[:, :60])
    assert torch.equal(Ag[:, :60].cpu(), Ac[:, :60])
    np.testing.assert_allclose(accg.cpu().numpy(), accc.numpy(), rtol=1e-12)


def _bucketed_hetero_points(n_requests=2000):
    """fig8-style points of three (n, m) shapes under heterogeneous
    prices (per-server dt) and lognormal sizes, AKPC and no_packing."""
    from repro_torch.bench.sweep_bench import env_for

    pts = []
    for seed, (n, m) in enumerate(((60, 20), (50, 24), (100, 40))):
        tr = synth_trace(SynthConfig(
            kind="netflix", n_items=n, n_servers=m, n_requests=n_requests,
            t_max=20.0, bundle_cover=1.0, bundle_zipf=0.7, seed=seed,
            size_dist="lognormal"))
        env = env_for(tr, CostParams(), 1.0)
        for name in ("akpc", "no_packing"):
            kw = dict(t_cg=0.9, top_frac=1.0) if name == "akpc" else {}
            pts.append(SweepPoint(name, tr, dict(
                params=CostParams(), env=env, cost_model="heterogeneous",
                **kw), tag=f"{n}x{m}/{name}"))
    return pts


def test_bucketed_mixed_sweep_on_card_equals_serial_card_runs(cuda_device):
    """A mixed-(n, m) sweep under the bucketed layout on the card: one
    scan a bucket cohort, one ``seg_scan_step`` launch a live step a
    scan, every point equal to its serial card run (dense): state float
    for float, costs at 1e-9."""
    from repro_torch.core.state_layout import StateLayout

    lay = StateLayout(kind="bucketed", row_bucket=64, col_bucket=32)
    pts = _bucketed_hetero_points()
    cohorts = {lay.state_dims(p.trace.n, p.trace.m) for p in pts}
    assert len(cohorts) == 2
    n0 = seg_scan_step.launches
    eng = SweepEngine(layout=lay)
    got = eng.run(pts)
    groups = eng.last_stats["groups"]
    assert len(groups) == len(cohorts)
    assert seg_scan_step.launches - n0 == sum(g["steps"] for g in groups)
    ser = SweepEngine(backend="serial").run(pts)
    for p, a, b in zip(pts, ser, got):
        assert np.array_equal(a.state.partition.clique_of,
                              b.state.partition.clique_of), p.tag
        assert np.array_equal(a.state.E, b.state.E), p.tag
        assert np.array_equal(a.state.anchor, b.state.anchor), p.tag
        assert a.costs.n_misses == b.costs.n_misses, p.tag
        assert np.isclose(a.total, b.total, rtol=1e-9, atol=0.0), p.tag


def test_bucketed_scan_step_equals_plain(cuda_device):
    """The scan step captured from a bucketed sweep (``dt`` padded past
    the servers, per-lane event rows) is bitwise its plain version, on two
    calls."""
    from repro_torch.core.state_layout import StateLayout
    from repro_torch.kernels import capture

    lay = StateLayout(kind="bucketed", row_bucket=64, col_bucket=32)
    pts = _bucketed_hetero_points()
    capture.INPUTS = {}
    try:
        SweepEngine(layout=lay).run(pts)
        args = capture.INPUTS["seg_scan_step"][1]
    finally:
        capture.INPUTS = None
    # both cohorts' columns pad past their servers (24 -> 32, 40 -> 64)
    assert args[6].shape[1] in (32, 64) and len(args) == 8
    want = seg_scan_step_plain(*args)
    for _ in range(2):
        got = seg_scan_step(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("shards", [2, 4])
def test_row_sharded_logical_mesh_equals_dense_card_run(cuda_device, shards):
    """The row-sharded state on a mesh of ``shards`` logical shards of
    cuda:0, per-server dt (``seg_scan_step`` once a live step, the host
    clique generation's kernels through the host schedule): state float
    for float and costs bit for bit against the dense card run, and the
    CPU run at 1e-9."""
    from repro_torch.bench.sweep_bench import env_for
    from repro_torch.core.sharded_state import ShardedRows
    from repro_torch.core.state_layout import StateLayout
    from repro_torch.launch.mesh import make_sweep_mesh

    tr = synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=40, n_requests=6000,
        t_max=20.0, bundle_cover=1.0, bundle_zipf=0.7, seed=3,
        size_dist="lognormal"))
    env = env_for(tr, CostParams(), 1.0)
    mesh = make_sweep_mesh(shards, state_rows=shards,
                           devices=["cuda:0"] * shards)
    lay = StateLayout(kind="row_sharded", mesh=mesh)

    def pol(name):
        kw = dict(t_cg=0.9, top_frac=1.0) if name == "akpc" else {}
        return get_policy(name, params=CostParams(), env=env,
                          cost_model="heterogeneous", **kw)

    for name in ("akpc", "no_packing"):
        n0 = seg_scan_step.launches
        got = run_policy(pol(name), tr, layout=lay)
        assert got.loop_stats["path"] == "host_schedule"
        assert got.loop_stats["shards"] == shards
        assert got.loop_stats["device_copies"] == 0
        assert seg_scan_step.launches - n0 == got.loop_stats["steps"] > 0
        dense = run_policy(pol(name), tr)
        assert np.array_equal(dense.state.E, got.state.E), name
        assert np.array_equal(dense.state.anchor, got.state.anchor), name
        assert dense.costs.as_dict() == got.costs.as_dict(), name
        cpu = run_policy(pol(name), tr, device="cpu")
        assert np.isclose(cpu.total, got.total, rtol=1e-9, atol=0.0), name
    E, _ = lay.place_state(np.zeros((lay.state_rows(60), 40)),
                           np.full(lay.state_rows(60), -1))
    assert isinstance(E, ShardedRows)
    assert all(b.device == torch.device("cuda", 0) for b in E.blocks)


def test_mesh_sweep_2x2_on_card_equals_meshless(cuda_device):
    """A 2 x 2 logical ("scenario", "state_row") mesh of cuda:0 under the
    row_sharded layout: every point equals the mesh-less card sweep, state
    float for float and costs at 1e-9 (lane blocks reduce the per-lane
    cost sums over other shapes)."""
    from repro_torch.bench.sweep_bench import fig10_points
    from repro_torch.core.state_layout import StateLayout
    from repro_torch.launch.mesh import make_sweep_mesh

    pts = fig10_points(3000)
    mesh = make_sweep_mesh(4, state_rows=2, devices=["cuda:0"] * 4)
    eng = SweepEngine(mesh=mesh, layout=StateLayout(kind="row_sharded"))
    got = eng.run(pts)
    groups = eng.last_stats["groups"]
    assert {g["block"] for g in groups} == {0, 1}
    assert all(g["shards"] == 2 for g in groups)
    base = SweepEngine().run(pts)
    for p, a, b in zip(pts, base, got):
        assert np.array_equal(a.state.E, b.state.E), p.tag
        assert np.array_equal(a.state.anchor, b.state.anchor), p.tag
        assert a.costs.n_misses == b.costs.n_misses, p.tag
        assert np.isclose(a.total, b.total, rtol=1e-9, atol=0.0), p.tag


def test_mesh_on_distinct_cards(cuda_device):
    """Row blocks and lane blocks on distinct cards (skips on one card):
    the routed state crosses devices and still equals the dense run on
    cuda:0 bit for bit; a sweep on a (cards / 2) x 2 mesh equals the
    mesh-less sweep (state; costs at 1e-9)."""
    from repro_torch.bench.sweep_bench import env_for, fig10_points
    from repro_torch.core.state_layout import StateLayout
    from repro_torch.launch.mesh import make_sweep_mesh

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more CUDA devices")
    k = 4 if n_cards >= 4 else 2
    tr = synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=40, n_requests=6000,
        t_max=20.0, bundle_cover=1.0, bundle_zipf=0.7, seed=3,
        size_dist="lognormal"))
    env = env_for(tr, CostParams(), 1.0)

    def pol():
        return get_policy("akpc", params=CostParams(), env=env,
                          cost_model="heterogeneous", t_cg=0.9, top_frac=1.0)

    lay = StateLayout(kind="row_sharded", mesh=make_sweep_mesh(k, k))
    got = run_policy(pol(), tr, layout=lay)
    assert got.loop_stats["shards"] == k
    assert got.loop_stats["device_copies"] > 0
    dense = run_policy(pol(), tr, device="cuda:0")
    assert np.array_equal(dense.state.E, got.state.E)
    assert np.array_equal(dense.state.anchor, got.state.anchor)
    assert dense.costs.as_dict() == got.costs.as_dict()
    pts = fig10_points(3000)
    mesh = make_sweep_mesh(k, state_rows=2)
    eng = SweepEngine(mesh=mesh, layout=StateLayout(kind="row_sharded"))
    swept = eng.run(pts)
    assert len({g["device"] for g in eng.last_stats["groups"]}) == k // 2
    base = SweepEngine(device="cuda:0").run(pts)
    for p, a, b in zip(pts, base, swept):
        assert np.array_equal(a.state.E, b.state.E), p.tag
        assert np.isclose(a.total, b.total, rtol=1e-9, atol=0.0), p.tag


# ---------------------------------------------------------------------------
# the model zoo's decoder family and BatchedServer
# ---------------------------------------------------------------------------
#: the decoder-family smoke configs
DECODERS = ["qwen2_5_3b", "codeqwen1_5_7b", "h2o_danube_1_8b",
            "command_r_35b", "granite_moe_3b_a800m", "phi_3_vision_4_2b"]
#: the card's logits against the CPU's, as a share of the CPU's largest:
#: f32 products summed in other orders (TF32 off); bf16 keeps 8 bits
MODEL_TOL = {"float32": 1e-4, "bfloat16": 6e-2}


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODERS)
def test_model_decode_on_card_equals_cpu(cuda_device, arch, dtype):
    """A smoke model's ``decode_step`` on the card against the port's CPU
    run on the same weights: 5 steps at staggered positions, the cache in
    the config's KV dtype."""
    cfg = get_smoke_config(arch)
    cfg = _f32(cfg) if dtype == "float32" else cfg
    gm, cm = build_model(cfg, device=cuda_device), build_model(cfg,
                                                              device="cpu")
    cp = cm.init(0)
    gp = tree_map(lambda a: a.to(cuda_device), cp)
    kv = torch.int8 if cfg.kv_cache_dtype == "int8" else getattr(torch, dtype)
    cc, gc = cm.init_cache(3, 40, kv), gm.init_cache(3, 40, kv)
    rng = np.random.default_rng(3)
    pos = torch.tensor([0, 6, 33], dtype=torch.int32)
    for _ in range(5):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1)))
        gl, gc = gm.decode_step(gp, gc, tok.to(cuda_device),
                                pos.to(cuda_device))
        cl, cc = cm.decode_step(cp, cc, tok, pos)
        gap = (gl.cpu().float() - cl.float()).abs().max() / cl.float().abs().max()
        assert float(gap) <= MODEL_TOL[dtype], float(gap)
        pos = pos + 1


def test_moe_combine_repeats_bit_for_bit(cuda_device):
    """One full-width granite MoE layer twice on the same tokens: the same
    bits (the combine sums each token's k rows in a fixed order)."""
    cfg = get_config("granite_moe_3b_a800m")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = {k: v[0] for k, v in init_moe(gen, cfg, 1, torch.bfloat16).items()}
    x = torch.randn((4, 16, cfg.d_model), generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    y1, a1 = moe_forward(p, x, cfg)
    y2, a2 = moe_forward(p, x, cfg)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    yc, _ = moe_forward({k: v.cpu() for k, v in p.items()}, x.cpu(), cfg)
    gap = (y1.cpu().float() - yc.float()).abs().max() / yc.float().abs().max()
    assert float(gap) <= MODEL_TOL["bfloat16"]


def test_expert_gather_through_packed_lookup(cuda_device):
    """``packed_tables`` -> ``packed_lookup`` of layer 0's ``wi`` at
    granite's expert width (multi-MB rows: ``sliced``) == the plain
    gather, bit for bit."""
    rng = np.random.default_rng(4)
    mgr = ExpertCacheManager(n_experts=40, n_hosts=2, t_cg=24.0,
                             device=cuda_device)
    for _ in range(60):
        g = int(rng.integers(0, 8))
        mgr.observe(rng.integers(5 * g, 5 * g + 5, size=(8, 8)), host=0)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    wi = torch.randn((1, 48, 1536, 512), generator=gen, device=cuda_device
                     ).to(torch.bfloat16)
    params = {"layers": {"mlp": {"wi": wi}}}
    before = packed_lookup.launches
    out = example.expert_gather(mgr, params, np.arange(10))
    assert packed_lookup.launches == before + 1
    assert packed_lookup.last_path == "sliced"
    assert torch.equal(out["rows"], packed_lookup_plain(out["table"],
                                                        out["ids"]))
    rows = wi[0].reshape(48, -1)
    for r, c in enumerate(out["ids"].tolist()):
        for slot in range(out["table"].shape[1]):
            members = np.flatnonzero((out["where"][:, 0] == c)
                                     & (out["where"][:, 1] == slot))
            if members.size:
                assert torch.equal(out["rows"][r, slot], rows[members[0]])


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "granite_moe_3b_a800m"])
def test_server_staggered_equals_solo_on_card(cuda_device, arch):
    model = build_model(get_smoke_config(arch), device=cuda_device)
    params = model.init(0)

    def solo(prompt):
        srv = BatchedServer(model, params, batch_size=2, cache_len=64)
        srv.submit(Request(rid=0, prompt=list(prompt), max_new=6))
        (r,) = srv.run(max_steps=200)
        return r.out

    p0, p1 = [1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7]
    srv = BatchedServer(model, params, batch_size=2, cache_len=64)
    srv.submit(Request(rid=0, prompt=list(p0), max_new=6))
    for _ in range(4):
        srv.step()
    srv.submit(Request(rid=1, prompt=list(p1), max_new=6))
    done = {r.rid: r.out for r in srv.run(max_steps=200)}
    assert done == {0: solo(p0), 1: solo(p1)}
