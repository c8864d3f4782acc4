"""The port's scan and gather kernels' plain versions against the JAX package.

On the CPU the wrappers ``seg_running_max`` / ``seg_running_argmax`` /
``packed_lookup`` run their plain versions.  Those must equal the Pallas
kernels run in interpret mode (under ``jax.enable_x64``) and the numpy
oracles ``seg_running_*_ref`` bit for bit: the scans only select values,
the gather only copies.  Shapes are ragged (L on both sides of the
replay's 8192) with tie-heavy values and -inf entries; ``clique_lookup``
must equal the reference's, padding slots included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.packed_lookup import clique_lookup as ref_clique_lookup
from repro.kernels.packed_lookup import packed_lookup as pallas_packed_lookup
from repro.kernels.segment_reduce import seg_running_argmax as pallas_argmax
from repro.kernels.segment_reduce import seg_running_argmax_ref
from repro.kernels.segment_reduce import seg_running_max as pallas_max
from repro.kernels.segment_reduce import seg_running_max_ref

from repro_torch.kernels import (
    packed_lookup,
    packed_lookup_plain,
    seg_running_argmax,
    seg_running_argmax_plain,
    seg_running_max,
    seg_running_max_plain,
)
from repro_torch.kernels.packed_lookup import CliqueLookup, clique_lookup

LENGTHS = [1, 7, 8191, 8193]
STARTS = ["all", "first", "p0.01", "p0.5", "none"]


def _inputs(L, starts, seed):
    """Values drawn from a few integers (ties everywhere) plus -inf."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 4, size=L).astype(np.float64)
    v[rng.random(L) < 0.1] = -np.inf
    if starts == "all":
        s = np.ones(L, bool)
    elif starts == "first":
        s = np.zeros(L, bool)
        s[0] = True
    elif starts == "none":          # position 0 starts a segment regardless
        s = np.zeros(L, bool)
    else:
        s = rng.random(L) < float(starts[1:])
    return v, s


@pytest.mark.parametrize("starts", STARTS)
@pytest.mark.parametrize("L", LENGTHS)
def test_seg_scans_equal_pallas_and_oracle(L, starts):
    v, s = _inputs(L, starts, L)
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    got_max = seg_running_max(tv, ts)
    got_v, got_i = seg_running_argmax(tv, ts)
    assert got_i.dtype == torch.int32
    with jax.enable_x64(True):
        pv = np.asarray(pallas_max(jnp.asarray(v), jnp.asarray(s),
                                   interpret=True))
        av, ai = pallas_argmax(jnp.asarray(v), jnp.asarray(s), interpret=True)
    ov = seg_running_max_ref(v, s)
    rv, ri = seg_running_argmax_ref(v, s)
    assert np.array_equal(got_max.numpy(), pv)
    assert np.array_equal(got_max.numpy(), ov)
    assert np.array_equal(got_v.numpy(), np.asarray(av))
    assert np.array_equal(got_i.numpy(), np.asarray(ai))
    assert np.array_equal(got_v.numpy(), rv)
    assert np.array_equal(got_i.numpy().astype(np.int64), ri)


@pytest.mark.parametrize("starts", ["first", "p0.01"])
def test_seg_scans_long_stream_equal_oracle(starts):
    """L = 100,000: longer than one block's 1024 threads x 64 positions."""
    v, s = _inputs(100_000, starts, 3)
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    assert np.array_equal(seg_running_max(tv, ts).numpy(),
                          seg_running_max_ref(v, s))
    got_v, got_i = seg_running_argmax(tv, ts)
    rv, ri = seg_running_argmax_ref(v, s)
    assert np.array_equal(got_v.numpy(), rv)
    assert np.array_equal(got_i.numpy().astype(np.int64), ri)


def test_seg_scans_plain_is_what_cpu_wrapper_runs():
    v, s = _inputs(513, "p0.5", 9)
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    assert torch.equal(seg_running_max(tv, ts), seg_running_max_plain(tv, ts))
    a, b = seg_running_argmax(tv, ts), seg_running_argmax_plain(tv, ts)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    e = torch.zeros(0, dtype=torch.float64)
    assert seg_running_max(e, torch.zeros(0, dtype=torch.bool)).shape == (0,)


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64])
@pytest.mark.parametrize("C,omega,d,R", [(4096, 5, 128, 300), (60, 1, 1, 777),
                                         (33, 3, 7, 64), (5, 2, 3, 1)])
def test_packed_lookup_equals_pallas(C, omega, d, R, dtype):
    rng = np.random.default_rng(C + R)
    table = (rng.standard_normal((C, omega, d)) * 100).astype(dtype)
    ids = rng.integers(0, C, size=R).astype(np.int32)
    got = packed_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    assert torch.equal(got, packed_lookup_plain(torch.from_numpy(table),
                                                torch.from_numpy(ids)))
    with jax.enable_x64(True):
        want = np.asarray(pallas_packed_lookup(
            jnp.asarray(table), jnp.asarray(ids), interpret=True))
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)


def test_packed_lookup_plain_refuses_out_of_range_ids():
    table = torch.zeros((4, 1, 1), dtype=torch.int32)
    with pytest.raises(IndexError):
        packed_lookup(table, torch.tensor([0, 4], dtype=torch.int32))


@pytest.mark.parametrize("n,shape", [(60, (500, 5)), (10_000, (4096,)),
                                     (1, (3, 2))])
def test_clique_lookup_equals_reference(n, shape):
    rng = np.random.default_rng(n)
    clique_of = rng.permutation(n).astype(np.int32)
    items = rng.integers(-1, n, size=shape)
    got = clique_lookup(clique_of, items, device="cpu")
    want = ref_clique_lookup(clique_of, items)
    assert np.array_equal(got, want)
    with jax.enable_x64(True):
        via_pallas = ref_clique_lookup(clique_of, items, use_pallas=True,
                                       interpret=True)
    assert np.array_equal(got, via_pallas)
    look = CliqueLookup("cpu")
    assert np.array_equal(look(clique_of, items), want)
    assert look.calls == 1 and look.bytes_down == 4 * items.size


def test_clique_lookup_refuses_ids_outside_catalog():
    with pytest.raises(IndexError):
        clique_lookup(np.arange(5, dtype=np.int32), np.array([0, 5]),
                      device="cpu")
