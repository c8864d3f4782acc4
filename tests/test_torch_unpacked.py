"""The port's unpacked gather, its ops hooks and its kernel bench on the CPU.

On the CPU ``unpacked_lookup`` runs its plain version.  It must equal the
Pallas ``unpacked_lookup`` run in interpret mode and the numpy oracle
``unpacked_lookup_ref`` at the kernel bench's shape and ragged ones, and
equal ``packed_lookup`` on the same bytes; ids out of range raise.  The
hooks of ``repro_torch.kernels.ops`` equal ``repro.kernels.ops`` on the
same arrays, and ``python -m repro_torch.bench.kernel_bench --device cpu``
runs its checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.packed_lookup import unpacked_lookup as pallas_unpacked
from repro.kernels.ref import unpacked_lookup_ref

from repro_torch.bench import common as bench_common
from repro_torch.bench import kernel_bench
from repro_torch.kernels import (
    KERNELS,
    packed_lookup,
    unpacked_lookup,
    unpacked_lookup_plain,
)
from repro_torch.kernels import ops

#: (n items, d, R, omega, dtype): the kernel bench's lookup, ragged rows,
#: one request, int32 / float64 items
CASES = [
    (640, 256, 64, 5, np.float32),
    (37, 1, 9, 5, np.int32),
    (50, 3, 1, 5, np.float64),
    (20, 255, 4, 3, np.float32),
    (12, 256, 1, 1, np.int32),
]


def _items(n, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * 100).astype(dtype)


@pytest.mark.parametrize("n,d,R,omega,dtype", CASES)
def test_unpacked_equals_pallas_and_oracle(n, d, R, omega, dtype):
    items = _items(n, d, dtype, n + d)
    rng = np.random.default_rng(R)
    ids = rng.integers(0, n, size=(R, omega)).astype(np.int32)
    got = unpacked_lookup(torch.from_numpy(items), torch.from_numpy(ids))
    assert got.shape == (R, omega, d)
    plain = unpacked_lookup_plain(torch.from_numpy(items),
                                  torch.from_numpy(ids))
    with jax.enable_x64(True):           # keep float64 items float64
        want = np.asarray(pallas_unpacked(
            jnp.asarray(items), jnp.asarray(ids), interpret=True))
        oracle = np.asarray(unpacked_lookup_ref(jnp.asarray(items),
                                                jnp.asarray(ids)))
    assert want.dtype == items.dtype
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("C,omega,d,R", [(128, 5, 256, 64), (7, 3, 5, 1),
                                         (31, 1, 1, 100)])
def test_packed_equals_unpacked_on_same_bytes(C, omega, d, R):
    """The packed table's cliques as item rows: the two gathers agree."""
    rng = np.random.default_rng(C)
    table = rng.standard_normal((C, omega, d)).astype(np.float32)
    cids = rng.integers(0, C, size=R).astype(np.int32)
    iids = (cids[:, None] * omega + np.arange(omega)[None, :]).astype(
        np.int32)
    packed = packed_lookup(torch.from_numpy(table), torch.from_numpy(cids))
    unpacked = unpacked_lookup(torch.from_numpy(table.reshape(C * omega, d)),
                               torch.from_numpy(iids))
    assert torch.equal(packed, unpacked)


@pytest.mark.parametrize("bad", [-1, 10])
def test_out_of_range_ids_raise(bad):
    items = torch.zeros((10, 4))
    with pytest.raises(IndexError):
        unpacked_lookup(items, torch.tensor([[0, bad]], dtype=torch.int32))
    with pytest.raises(IndexError):
        packed_lookup(items.reshape(10, 1, 4),
                      torch.tensor([bad], dtype=torch.int32))


def test_unpacked_is_a_registered_kernel():
    assert KERNELS["unpacked_lookup"] is unpacked_lookup
    assert unpacked_lookup.launches == 0     # the CPU never launches it


def test_ops_equal_reference_ops():
    """Each hook of the port equals the reference's on the same arrays."""
    rng = np.random.default_rng(5)
    H = (rng.random((300, 40)) < 0.1).astype(np.float32)
    assert np.array_equal(ops.crm_matmul(H, device="cpu"),
                          np.asarray(ref_ops.crm_matmul(jnp.asarray(H))))
    M = (rng.random((12, 40)) < 0.1).astype(np.float32)
    A = (rng.random((40, 40)) < 0.3).astype(np.float32)
    assert np.array_equal(
        ops.pair_edges(M, A, device="cpu"),
        np.asarray(ref_ops.pair_edges(jnp.asarray(M), jnp.asarray(A))))
    v = rng.integers(0, 4, size=300).astype(np.float64)
    s = rng.random(300) < 0.1
    with jax.enable_x64(True):
        rmax = np.asarray(ref_ops.seg_max(jnp.asarray(v), jnp.asarray(s)))
        rv, ri = ref_ops.seg_argmax(jnp.asarray(v), jnp.asarray(s))
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    assert np.array_equal(ops.seg_max(tv, ts).numpy(), rmax)
    gv, gi = ops.seg_argmax(tv, ts)
    assert np.array_equal(gv.numpy(), np.asarray(rv))
    assert np.array_equal(gi.numpy(), np.asarray(ri))
    table = rng.standard_normal((16, 5, 8)).astype(np.float32)
    cids = rng.integers(0, 16, size=6).astype(np.int32)
    assert np.array_equal(
        ops.gather_packed(torch.from_numpy(table),
                          torch.from_numpy(cids)).numpy(),
        np.asarray(ref_ops.gather_packed(jnp.asarray(table),
                                         jnp.asarray(cids))))
    items = table.reshape(80, 8)
    iids = rng.integers(0, 80, size=(6, 5)).astype(np.int32)
    assert np.array_equal(
        ops.gather_unpacked(torch.from_numpy(items),
                            torch.from_numpy(iids)).numpy(),
        np.asarray(ref_ops.gather_unpacked(jnp.asarray(items),
                                           jnp.asarray(iids))))


def test_ops_refuse_missing_cuda():
    """The numpy-in hooks run on CUDA by default: without a card they
    raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.crm_matmul(np.zeros((3, 4), np.float32))


def test_kernel_bench_smoke_on_cpu(tmp_path, monkeypatch, capsys):
    """``--device cpu``: every row's checks run, at the reference's inputs
    (numpy seed 0), and no time is reported for the CPU."""
    monkeypatch.setattr(bench_common, "RESULTS_DIR", str(tmp_path))
    recs = kernel_bench.main(["--device", "cpu", "--big-requests", "256",
                              "--big-slots", "98"])
    names = [r["name"] for r in recs]
    scans = ["seg_scan_step", "seg_running_argmax", "seg_running_max"]
    assert names == (["crm_update"] * 3 + ["clique_pair_edges"] * 2
                     + ["packed_lookup", "unpacked_lookup"] * 2
                     + scans * len(kernel_bench.SCAN_SHAPES)
                     * len(kernel_bench.SCAN_STARTS)
                     + ["merge_density"] * 7)
    merges = [r for r in recs if r["name"] == "merge_density"]
    assert [(r["shape"]["S"], r["shape"]["n_act"]) for r in merges] == [
        (64, None), (64, 32), (2048, None), (2048, 229), (2048, 2048),
        (98, None), (98, 49)]
    assert all(r["device_ms"] is None and r["x_entries_read"] > 0
               and r["bytes"] < r["bytes_all_x"] for r in merges)
    assert all(r["equal"] and r["ms"] is None for r in recs)
    assert all(r["device_ms"] is None for r in recs if r["name"] in scans)
    units = {(r["name"], r["shape"]["config"]): r["copy_units"]
             for r in recs if "copy_units" in r}
    assert units[("packed_lookup", "reference")] == 64
    assert units[("unpacked_lookup", "reference")] == 64 * 5
    assert units[("unpacked_lookup", "catalog-10k")] == 256 * 5
    assert (tmp_path / "torch_kernel_bench.json").exists()
    out = capsys.readouterr().out
    assert "kernel/unpacked_lookup/reference_C128_R64" in out
    assert "kernel/seg_scan_step/S1_L8192_starts0.01" in out
    assert "kernel/merge_density/S2048_k229" in out
