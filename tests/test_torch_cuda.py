"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device and ``nvcc`` (the kernels are built from
``src/repro_torch/csrc`` at first use); every test skips without a device.
Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports neither jax nor ``repro``, so it runs where only the
port's dependencies are installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (
    CacheEnvironment,
    CostParams,
    get_policy,
    run_policy,
)
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
)
from repro_torch.traces import SynthConfig, synth_trace

#: the kernels of the AKPC replay with the device clique generation
CGM_KERNELS = ("crm_update", "clique_pair_edges", "merge_density")


pytestmark = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device")


@pytest.fixture
def cuda_device():
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


@pytest.mark.parametrize("starts", ["all", "first", "0.01", "0.5"])
@pytest.mark.parametrize("L", [1, 7, 8191, 8193, 100_000])
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
    want = ["seg_running_argmax", "seg_running_max", "packed_lookup"]
    if name == "akpc":
        want += ["crm_update", "clique_pair_edges"]
    assert all(KERNELS[k].launches > 0 for k in want)
    assert gpu.loop_stats["path"] == "host_schedule"
    cpu = run_policy(policy(), trace, device="cpu")
    assert np.array_equal(gpu.state.partition.clique_of,
                          cpu.state.partition.clique_of)
    assert np.array_equal(gpu.state.E, cpu.state.E)
    assert np.array_equal(gpu.state.anchor, cpu.state.anchor)
    assert gpu.costs.n_misses == cpu.costs.n_misses
    assert gpu.costs.n_hits == cpu.costs.n_hits
    assert np.isclose(gpu.total, cpu.total, rtol=1e-9, atol=0.0)
