"""Each kernel module of the port against the JAX package's Pallas kernel.

On the CPU the port's wrappers run their plain versions; those must equal
the Pallas kernels run in interpret mode (under ``jax.enable_x64``) bit
for bit, since every result is an exact integer count or one IEEE
rounding.  Shapes sit on and off the tile multiples.  The CUDA kernels
themselves are held against the plain versions by tests/test_torch_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.clique_density import clique_pair_edges as pallas_pair_edges
from repro.kernels.crm_update import crm_update as pallas_crm_update
from repro.kernels.merge_step import merge_density as pallas_merge_density
from repro.kernels.ref import clique_pair_edges_ref, crm_ref

from repro_torch.bench.kernel_bench import worst_cases

from repro_torch.kernels import (
    clique_pair_edges,
    clique_pair_edges_plain,
    crm_update,
    crm_update_plain,
    merge_density,
    merge_density_plain,
)


def _incidence(rng, rows, h, d=5):
    """(rows, h) 0/1 request x hot-slot incidence, <= d slots a row."""
    H = np.zeros((rows, h), np.float32)
    cols = rng.integers(0, h, size=(rows, d))
    keep = rng.random((rows, d)) < 0.6
    r = np.repeat(np.arange(rows), d).reshape(rows, d)
    H[r[keep], cols[keep]] = 1.0
    return H


def _membership(rng, S, h, groups=None):
    """(S, h) 0/1 membership: every hot slot in at most one group (of the
    first ``groups`` rows)."""
    M = np.zeros((S, h), np.float32)
    grp = rng.integers(-1, S if groups is None else groups, size=h)
    ok = grp >= 0
    M[grp[ok], np.arange(h)[ok]] = 1.0
    return M


def _binary(rng, h, p=0.2):
    A = rng.random((h, h)) < p
    A = np.triu(A, 1)
    return (A | A.T).astype(np.float32)


@pytest.mark.parametrize("rows,h", [(300, 32), (257, 40), (128, 128),
                                    (130, 129), (1, 7)])
def test_crm_update_plain_equals_pallas(rows, h):
    rng = np.random.default_rng(rows * 1000 + h)
    H = _incidence(rng, rows, h)
    with jax.enable_x64(True):
        want = np.asarray(pallas_crm_update(jnp.asarray(H), interpret=True))
    got = crm_update(torch.from_numpy(H))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(crm_update_plain(torch.from_numpy(H)).numpy(), want)


@pytest.mark.parametrize("name", ["crm_update", "clique_pair_edges"])
def test_worst_cases_plain_equals_reference(name):
    """The inputs on which the card tests hold the sparse kernels
    (``kernel_bench.worst_cases``) are what their labels say, and on them
    the wrapper (the plain version on the CPU) equals the reference's jnp
    oracle bit for bit."""
    cases = [c for c in worst_cases("cpu") if c[0] == name]
    labels = " | ".join(c[1] for c in cases)
    if name == "crm_update":
        for word in ("density 0.5", "all ones", "one row of ones",
                     "all zero", "strided", "ragged"):
            assert word in labels
        widths = set()
        for label, (H,) in ((c[1], c[2]) for c in cases):
            if "strided" in label:
                assert H.stride(0) == H.shape[1] + 1, label
                widths.add(H.shape[1])
            with jax.enable_x64(True):
                want = np.asarray(crm_ref(jnp.asarray(H.numpy())))
            assert np.array_equal(crm_update(H).numpy(), want), label
        assert {1, 6, 32, 1000, 1024} <= widths
    else:
        for word in ("density 0.3", "empty rows", "all zero", "S 1",
                     "h 1"):
            assert word in labels
        for label, (M, A) in ((c[1], c[2]) for c in cases):
            with jax.enable_x64(True):
                want = np.asarray(clique_pair_edges_ref(
                    jnp.asarray(M.numpy()), jnp.asarray(A.numpy())))
            assert np.array_equal(clique_pair_edges(M, A).numpy(), want), \
                label


@pytest.mark.parametrize("S,h", [(64, 32), (70, 33), (256, 128), (2, 130)])
def test_clique_pair_edges_plain_equals_pallas(S, h):
    rng = np.random.default_rng(S * 1000 + h)
    M = _membership(rng, S, h)
    A = _binary(rng, h)
    with jax.enable_x64(True):
        want = np.asarray(pallas_pair_edges(jnp.asarray(M), jnp.asarray(A),
                                            interpret=True))
    got = clique_pair_edges(torch.from_numpy(M), torch.from_numpy(A))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        clique_pair_edges_plain(torch.from_numpy(M),
                                torch.from_numpy(A)).numpy(), want)


@functools.lru_cache(maxsize=None)
def _merge_case(S, omega, gamma):
    """X, sizes and the Pallas kernel's D (interpret mode) of one case."""
    rng = np.random.default_rng(S * 10 + omega)
    h = S // 2 + 1
    M = _membership(rng, S, h, groups=max(2, h // 2))
    A = _binary(rng, h, p=0.9)
    X = (M @ A @ M.T).astype(np.float32)
    sizes = M.sum(axis=1).astype(np.int32)
    with jax.enable_x64(True):
        D = np.asarray(pallas_merge_density(
            jnp.asarray(X), jnp.asarray(sizes), np.int32(omega),
            np.float32(gamma), interpret=True))
    return X, sizes, D


#: n_act cases: the TPU function (None), the edges and a third of S
N_ACT = (None, 0, 1, 2, "S//3", "S-1", "S")


@pytest.mark.parametrize("n_act", N_ACT)
@pytest.mark.parametrize("S,omega,gamma", [(64, 5, 0.85), (70, 3, 0.6),
                                           (200, 4, 0.95), (5, 2, 0.0),
                                           (75, 5, 0.85)])
def test_merge_density_plain_equals_pallas(S, omega, gamma, n_act):
    """The wrapper (on the CPU) and the plain version equal the Pallas
    kernel, and with ``n_act=k`` the Pallas kernel followed by the
    reference merge's act mask (``core/cgm_jax.py::_approx_merge``):
    S % 4 in 0..3, k at every edge."""
    X, sizes, want = _merge_case(S, omega, gamma)
    assert (want >= 0.0).any()                     # some pairs pass
    k = {"S//3": S // 3, "S-1": S - 1, "S": S}.get(n_act, n_act)
    if k is not None:
        with jax.enable_x64(True):
            slot = jnp.arange(S)
            act = slot < k
            eyeS = jnp.eye(S, dtype=bool)
            actp = act[:, None] & act[None, :] & ~eyeS
            want = np.asarray(jnp.where(actp, jnp.asarray(want), -2.0))
        assert want.dtype == np.float32
    got = merge_density(torch.from_numpy(X), torch.from_numpy(sizes), omega,
                        float(np.float32(gamma)), n_act=k)
    assert np.array_equal(got.numpy(), want)
    plain = merge_density_plain(torch.from_numpy(X), torch.from_numpy(sizes),
                                omega, float(np.float32(gamma)), n_act=k)
    assert np.array_equal(plain.numpy(), want)


def test_merge_density_refuses_n_act_out_of_range():
    X = torch.zeros((4, 4), dtype=torch.float32)
    sizes = torch.ones(4, dtype=torch.int32)
    for bad in (-1, 5):
        with pytest.raises(ValueError, match="n_act"):
            merge_density(X, sizes, 2, 0.5, n_act=bad)
    with pytest.raises(TypeError):
        merge_density(X, sizes, 2, 0.5, n_act=2.0)


def test_approx_merge_builds_d_in_one_call(monkeypatch):
    """The device CGM's approximate merge builds its starting D with one
    ``merge_density`` call that carries the act count, and the capture
    keeps that count with the merge's inputs."""
    from repro_torch.core import CostParams, cgm, get_policy
    from repro_torch.core.policy import run_policy
    from repro_torch.kernels import capture
    from repro_torch.traces import SynthConfig, synth_trace

    calls = []
    merges = []
    real_merge, real_approx = cgm.merge_density, cgm._approx_merge

    def counting_merge(X, sizes, omega, gamma32, n_act=None):
        calls.append(n_act)
        return real_merge(X, sizes, omega, gamma32, n_act=n_act)

    def counting_approx(*a, **kw):
        merges.append(len(calls))
        return real_approx(*a, **kw)

    monkeypatch.setattr(cgm, "merge_density", counting_merge)
    monkeypatch.setattr(cgm, "_approx_merge", counting_approx)
    trace = synth_trace(SynthConfig(
        kind="netflix", n_items=48, n_servers=6, n_requests=900, t_max=9.0,
        bundle_cover=1.0, bundle_zipf=0.7, seed=5))
    pol = get_policy("akpc", params=CostParams(theta=0.1, gamma=0.6,
                                               omega=3),
                     t_cg=0.73, top_frac=0.5)
    capture.INPUTS = {}
    try:
        res = run_policy(pol, trace, device="cpu")
        kept = capture.INPUTS["merge_density"]
    finally:
        capture.INPUTS = None
    assert res.n_windows >= 3
    assert merges and len(calls) == len(merges)    # one call a merge
    assert all(isinstance(k, int) and k >= 0 for k in calls)
    size, (X, sizes, omega, g32, n_act0) = kept
    assert n_act0 == size == max(calls)
    assert X.shape == (sizes.shape[0],) * 2 and omega == 3
