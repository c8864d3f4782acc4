"""The shapes of the kernels' newer CUDA paths, on the CPU, against the JAX
package's Pallas kernels.

``crm_update``'s ``mid`` path (32 < h <= 64, a lane a row) and
``packed_lookup``'s ``stream`` path (rows of a 6 MB slice or more) run
only on the card, where ``tests/test_torch_cuda.py`` holds them bit for
bit against the plain versions.  Here the wrappers run those plain
versions on the inputs the card tests use, cut to a small size: laned,
strided incidences with rows of ones, empty and equal rows
(``kernel_bench.mid_crm_case``), and rows of about a megabyte gathered
with repeated, unsorted ids.  Each must equal the Pallas kernel run in
interpret mode (and, for the CRM, the reference's jnp twin) bit for bit:
the counts are exact integers and a gather moves bytes only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.crm_update import crm_update as pallas_crm_update
from repro.kernels.crm_update import crm_update_jnp
from repro.kernels.packed_lookup import packed_lookup as pallas_packed_lookup

from repro_torch.bench import kernel_bench
from repro_torch.kernels import crm_update, packed_lookup

#: rows of the laned CRM inputs: past the equal-row run at 300-369
CRM_ROWS = 400


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("h", kernel_bench.MID_HS)
def test_mid_width_laned_crm_equals_pallas(h, lanes, extra):
    """A laned (or, at one lane, 2-D) strided H at 32 < h <= 64 gives, lane
    by lane, the Pallas kernel's and the jnp twin's counts."""
    label, H = kernel_bench.mid_crm_case(lanes, h, extra, CRM_ROWS, "cpu")
    assert H.shape[-1] == h and H.stride(-2) == h + extra, label
    got = crm_update(H)
    assert got.shape == (*H.shape[:-2], h, h) and got.dtype == torch.float32
    Hl, got_l = (H, got) if lanes > 1 else (H[None], got[None])
    for lane in range(lanes):
        Hn = jnp.asarray(Hl[lane].contiguous().numpy())
        assert float(Hn[7].sum()) == h and float(Hn[100:164].sum()) == 0.0
        with jax.enable_x64(True):
            want = np.asarray(pallas_crm_update(Hn, interpret=True))
            twin = np.asarray(crm_update_jnp(Hn))
        assert np.array_equal(got_l[lane].numpy(), want), (label, lane)
        assert np.array_equal(want, twin), (label, lane)


@pytest.mark.parametrize("dtype", ["float32", "int16", "bfloat16"])
@pytest.mark.parametrize("R", [1, 2, 5])
def test_megabyte_rows_lookup_equals_pallas(R, dtype):
    """``packed_lookup`` of (C 4, omega 2, d) tables with 1 MB rows at R
    1, 2 and 5 (unsorted, repeated ids) gives the Pallas gather's bits."""
    rng = np.random.default_rng(R)
    C, omega = 4, 2
    d = (1 << 20) // omega // (4 if dtype == "float32" else 2)
    if dtype == "float32":
        host = rng.standard_normal((C, omega, d)).astype(np.float32)
        jt, tt = jnp.asarray(host), torch.from_numpy(host)
    elif dtype == "int16":
        host = rng.integers(-(1 << 15), 1 << 15, (C, omega, d), dtype=np.int16)
        jt, tt = jnp.asarray(host), torch.from_numpy(host)
    else:
        # finite values (XLA may canonicalise a NaN's payload), as bits
        jt = jnp.asarray(rng.standard_normal((C, omega, d)), jnp.bfloat16)
        host = np.asarray(jt).view(np.int16).copy()
        tt = torch.from_numpy(host).view(torch.bfloat16)
    ids = {1: [2], 2: [3, 0]}.get(R, [1, 3, 1, 0, 3])
    ids_np = np.asarray(ids, np.int32)
    got = packed_lookup(tt, torch.from_numpy(ids_np))
    assert got.shape == (R, omega, d) and got.dtype == tt.dtype
    want = np.asarray(pallas_packed_lookup(jt, jnp.asarray(ids_np),
                                           interpret=True))
    if dtype == "bfloat16":
        got, want = got.view(torch.int16), want.view(np.int16)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), host[ids_np].view(got.numpy().dtype))
