"""Alg. 2's incidence built where the ``crm_matmul`` hook runs, from the
window's hot id lists (``CrmMatmul.from_ids``), on the CPU.

* ``build_window_crm`` through the autowired hook's id entry gives
  ``raw``, ``norm`` and ``binary`` bit for bit equal to the numpy pair
  scatter (no hook) and to the host-``H`` hook path, on padding, ids
  repeated in a request, all-cold rows, one hot item, widths 1 to
  ``_SCATTER_MAX_WIDTH + 1`` and windows past the scatter's dense cut;
* a host-schedule replay under per-server dt with the autowired hooks
  equals the hook-less one, and counts one id window a window;
* the ``(H) -> H^T H`` contract stands for custom hooks and direct calls;
* on the card (``gpu``): the device ``H`` equals ``incidence_matrix`` and
  ``crm_update`` takes the host path's route.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CostParams, get_policy
from repro_torch.core import crm
from repro_torch.core.cost import CacheEnvironment
from repro_torch.core.replay import run_policy_torch
from repro_torch.kernels import ops
from repro_torch.kernels.autowire import cgm_hooks, incidence_from_ids
from repro_torch.traces.synthetic import SynthConfig, synth_trace

WIDTHS = (1, 2, 5, 17, crm._SCATTER_MAX_WIDTH, crm._SCATTER_MAX_WIDTH + 1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread (many tiny ops under the parallel
    test run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(rng, B, d, n, cold_rows=0, repeats=True):
    """(B, d) int32 ids in [0, n) padded with -1; a few requests repeat
    an item; the last ``cold_rows`` requests hold only items above n // 2
    and none below (cold at a small top_frac of the window)."""
    items = rng.integers(0, n // 2, size=(B, d)).astype(np.int32)
    items[rng.random((B, d)) < 0.3] = -1
    if repeats and d > 1:
        rows = rng.choice(B, size=max(1, B // 10), replace=False)
        items[rows, 1] = items[rows, 0]
    if cold_rows:
        items[B - cold_rows:] = -1
        items[B - cold_rows:, 0] = n - 1
    return items


def _paths(items, n, theta, top_frac, top_frac_of="window"):
    """The window's CRM through the id entry, the host-H hook and the
    numpy pair scatter; the id hook."""
    mm, _ = cgm_hooks("cpu")
    kw = dict(top_frac_of=top_frac_of)
    ids = crm.build_window_crm(items, n, theta, top_frac, crm_matmul=mm, **kw)
    host = crm.build_window_crm(items, n, theta, top_frac,
                                crm_matmul=lambda H: mm(H), **kw)
    scatter = crm.build_window_crm(items, n, theta, top_frac, **kw)
    return ids, host, scatter, mm


def _same(a, b):
    assert np.array_equal(a.hot_items, b.hot_items)
    for key in ("raw", "norm", "binary"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert x.tobytes() == y.tobytes(), key


@pytest.mark.parametrize("d", WIDTHS)
def test_id_path_equals_host_h_and_scatter(d):
    rng = np.random.default_rng(d)
    items = _window(rng, 300, d, 80, cold_rows=7)
    ids, host, scatter, mm = _paths(items, 80, 0.2, 0.5)
    assert ids.n_hot > 1 and ids.raw.any() == (d > 1)   # d 1: no pairs
    _same(ids, host)
    _same(ids, scatter)
    assert mm.id_windows == 1


@pytest.mark.parametrize("top_frac_of", ["window", "catalog"])
def test_id_path_past_the_dense_cut(top_frac_of):
    """B h^2 > 2^25: the numpy counts take the sorted pair scatter."""
    rng = np.random.default_rng(5)
    items = rng.integers(-1, 600, size=(400, 6)).astype(np.int32)
    ids, host, scatter, _ = _paths(items, 600, 0.1, 1.0, top_frac_of)
    assert 400 * ids.n_hot ** 2 > (1 << 25)
    _same(ids, host)
    _same(ids, scatter)


def test_id_path_one_hot_item_and_all_cold_rows():
    rng = np.random.default_rng(2)
    items = _window(rng, 120, 5, 40, cold_rows=30)
    ids, host, scatter, _ = _paths(items, 40, 0.2, 0.01)
    assert ids.n_hot == 1
    _same(ids, host)
    _same(ids, scatter)
    cold = np.full((50, 4), -1, np.int32)
    cold[:, 0] = 7                      # one item a request: no pair at all
    for got in _paths(cold, 40, 0.2, 1.0)[:2]:
        _same(got, _paths(cold, 40, 0.2, 1.0)[2])
        assert not got.raw.any()


@pytest.mark.parametrize("h", [0, 1, 3])
def test_id_entry_zero_requests(h):
    """A window of no requests: the id entry and the host-H call give the
    same empty counts (``build_window_crm`` itself refuses such a window
    on every path alike: min-max of an empty CRM)."""
    mm, _ = cgm_hooks("cpu")
    compact = np.zeros((0, 5), np.int32)
    got = mm.from_ids(compact, h)
    want = mm(crm.incidence_matrix(compact, h))
    assert got.shape == want.shape == (h, h) and not got.any()
    assert mm.id_windows == 1 and mm.id_bytes == 0
    raised = []
    for hook in (mm, lambda H: mm(H), None):
        with pytest.raises(ValueError) as err:
            crm.build_window_crm(compact, 50, 0.2, 0.5, crm_matmul=hook)
        raised.append(str(err.value))
    assert len(set(raised)) == 1


def test_device_incidence_equals_host_incidence():
    rng = np.random.default_rng(7)
    for d in WIDTHS:
        compact = _window(rng, 257, d, 90)
        compact[compact >= 45] = -1
        got = incidence_from_ids(torch.from_numpy(compact), 45)
        assert got.is_contiguous() and got.stride() == (45, 1)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), crm.incidence_matrix(compact, 45))


def test_id_counter_counts_windows_and_bytes():
    mm, _ = cgm_hooks("cpu")
    rng = np.random.default_rng(3)
    want = 0
    for w in range(4):
        items = _window(rng, 100 + 10 * w, 5, 60, cold_rows=3)
        crm.build_window_crm(items, 60, 0.2, 0.5, crm_matmul=mm)
        want += items.size * np.dtype(np.int32).itemsize
    assert mm.id_windows == 4
    assert mm.id_bytes == want


def test_custom_hook_gets_dense_h_and_direct_calls_unchanged():
    rng = np.random.default_rng(4)
    items = _window(rng, 200, 5, 60, cold_rows=9)
    seen = []

    def hook(H):
        seen.append(H)
        return H.T @ H

    got = crm.build_window_crm(items, 60, 0.2, 0.5, crm_matmul=hook)
    (H,) = seen
    assert H.dtype == np.float32 and H.shape == (200, got.n_hot)
    assert set(np.unique(H)) <= {0.0, 1.0}
    _same(got, crm.build_window_crm(items, 60, 0.2, 0.5))
    mm, _ = cgm_hooks("cpu")
    want = H.T @ H
    np.fill_diagonal(want, 0.0)
    assert np.array_equal(mm(H), want)
    assert np.array_equal(ops.crm_matmul(H, device="cpu"), want)
    assert mm.id_windows == 0 and mm.id_bytes == 0


def _hetero_run(**hooks):
    tr = synth_trace(SynthConfig(
        kind="spotify", n_items=120, n_servers=12, n_requests=3000,
        t_max=20.0, bundle_cover=1.0, bundle_zipf=0.7, seed=11,
        size_dist="lognormal"))
    params = CostParams()
    env = CacheEnvironment.skewed(tr.n, tr.m, params, price_sigma=1.0, seed=1)
    pol = get_policy("akpc", params=params, t_cg=1.3, top_frac=0.5, env=env,
                     cost_model="heterogeneous", **hooks)
    return run_policy_torch(pol, tr, device="cpu")


def test_host_schedule_replay_with_id_hooks_equals_hookless():
    mm, pe = cgm_hooks("cpu")
    got = _hetero_run(crm_matmul=mm, pair_edges=pe)
    want = _hetero_run()
    assert got.loop_stats["path"] == want.loop_stats["path"] == "host_schedule"
    assert not got.loop_stats["const_dt"]
    assert got.costs.as_dict() == want.costs.as_dict()
    assert np.array_equal(got.state.partition.clique_of,
                          want.state.partition.clique_of)
    assert got.n_windows == want.n_windows > 1
    assert got.loop_stats["crm_id_windows"] == got.n_windows
    assert got.loop_stats["crm_id_bytes"] == mm.id_bytes > 0
    assert want.loop_stats["crm_id_windows"] == 0
    custom = _hetero_run(crm_matmul=lambda H: mm(H), pair_edges=pe)
    assert custom.costs.as_dict() == want.costs.as_dict()
    assert custom.loop_stats["crm_id_windows"] == 0
    assert custom.loop_stats["crm_id_bytes"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_id_path_catalog_slice(cuda_device):
    """A hetero-catalog-like slice (20,000 requests of up to 5 items, h
    1,000): the device H bit for bit, the same kernel route and counts as
    the host-H path, and ``build_window_crm`` equal to the scatter."""
    from repro_torch.kernels.crm_update import crm_update

    rng = np.random.default_rng(0)
    h = 1000
    compact = rng.integers(0, h, size=(20000, 5)).astype(np.int32)
    compact[rng.random(compact.shape) < 0.35] = -1
    compact[::17, 1] = compact[::17, 0]
    H_dev = incidence_from_ids(torch.from_numpy(compact).to(cuda_device), h)
    want_H = crm.incidence_matrix(compact, h)
    assert H_dev.is_contiguous() and H_dev.stride() == (h, 1)
    assert np.array_equal(H_dev.cpu().numpy(), want_H)
    mm, _ = cgm_hooks(cuda_device)
    host_counts = mm(want_H)
    host_path = crm_update.last_path
    id_counts = mm.from_ids(compact, h)
    assert crm_update.last_path == host_path is not None
    assert np.array_equal(id_counts, host_counts)
    items = rng.integers(-1, 10000, size=(20000, 5)).astype(np.int32)
    got = crm.build_window_crm(items, 10000, 0.2, 0.1, crm_matmul=mm,
                               top_frac_of="catalog")
    _same(got, crm.build_window_crm(items, 10000, 0.2, 0.1,
                                    top_frac_of="catalog"))
    assert mm.id_windows == 2
