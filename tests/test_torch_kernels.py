"""Each kernel module of the port against the JAX package's Pallas kernel.

On the CPU the port's wrappers run their plain versions; those must equal
the Pallas kernels run in interpret mode (under ``jax.enable_x64``) bit
for bit, since every result is an exact integer count or one IEEE
rounding.  Shapes sit on and off the tile multiples.  The CUDA kernels
themselves are held against the plain versions by tests/test_torch_cuda.py.
"""
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


@pytest.mark.parametrize("S,omega,gamma", [(64, 5, 0.85), (70, 3, 0.6),
                                           (200, 4, 0.95), (5, 2, 0.0)])
def test_merge_density_plain_equals_pallas(S, omega, gamma):
    rng = np.random.default_rng(S * 10 + omega)
    h = S // 2 + 1
    M = _membership(rng, S, h, groups=max(2, h // 2))
    A = _binary(rng, h, p=0.9)
    X = (M @ A @ M.T).astype(np.float32)
    sizes = M.sum(axis=1).astype(np.int32)
    with jax.enable_x64(True):
        want = np.asarray(pallas_merge_density(
            jnp.asarray(X), jnp.asarray(sizes), np.int32(omega),
            np.float32(gamma), interpret=True))
    assert (want >= 0.0).any()                     # some pairs pass
    got = merge_density(torch.from_numpy(X), torch.from_numpy(sizes), omega,
                        float(np.float32(gamma)))
    assert np.array_equal(got.numpy(), want)
    plain = merge_density_plain(torch.from_numpy(X), torch.from_numpy(sizes),
                                omega, float(np.float32(gamma)))
    assert np.array_equal(plain.numpy(), want)
