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

from repro_torch.core import CostParams, get_policy, run_policy
from repro_torch.kernels import (
    KERNELS,
    clique_pair_edges,
    clique_pair_edges_plain,
    crm_update,
    crm_update_plain,
    merge_density,
    merge_density_plain,
)
from repro_torch.traces import SynthConfig, synth_trace


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
    assert all(fn.launches > 0 for fn in KERNELS.values())
    cpu = run_policy(policy(), trace, device="cpu")
    assert np.array_equal(gpu.state.partition.clique_of,
                          cpu.state.partition.clique_of)
    assert np.array_equal(gpu.state.E, cpu.state.E)
    assert np.array_equal(gpu.state.anchor, cpu.state.anchor)
    assert gpu.costs.n_misses == cpu.costs.n_misses
    assert np.isclose(gpu.total, cpu.total, rtol=1e-9, atol=0.0)
