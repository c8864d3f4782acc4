"""The port's two cache consumers against the reference's, on the CPU.

* ``PackedDataPipeline``: the token batches equal the reference's bit for
  bit (the stream is numpy and backend-blind); it resumes from
  ``load_state_dict``; its shard cache's costs equal the reference's
  session backend at 1e-9 (integer counters exact); the ``live`` backend
  equals the ``session`` backend;
* ``ExpertCacheManager``: AKPC beats ``no_packing`` on co-activated
  experts; a standby restored from a snapshot keeps observing like the
  primary; snapshots cross the packages in both directions; the
  ``live`` backend equals the ``session`` backend (``stats()``) and its
  snapshot restores into a ``session`` manager; ``packed_tables`` equals
  the reference's bit for bit;
* both refuse an unknown backend.
"""
import numpy as np
import pytest

from repro.data import PackedDataPipeline as RefPipeline
from repro.data import ShardStore as RefStore
from repro.serving.expert_cache import ExpertCacheManager as RefManager

from repro_torch.data import PackedDataPipeline, ShardStore, TokenBatcher
from repro_torch.serving import ExpertCacheManager

COUNTERS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
            "items_transferred")
FLOATS = ("transfer", "caching", "keepalive_rent", "total")
#: relative tolerance of the cache's float costs (the reference's bar)
RTOL = 1e-9
STORE = dict(n_shards=64, shard_tokens=256, vocab=100, n_domains=8, seed=0)
PIPE = dict(batch_rows=8, seq_len=32, t_cg=16.0)


def _same_costs(a, b):
    da, db = a.as_dict(), b.as_dict()
    for f in COUNTERS:
        assert da[f] == db[f], f"{f}: {da[f]} != {db[f]}"
    for f in FLOATS:
        assert np.isclose(da[f], db[f], rtol=RTOL, atol=1e-12), \
            f"{f}: {da[f]!r} != {db[f]!r}"


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------
def test_shard_store_equals_reference():
    ref, port = RefStore(**STORE), ShardStore(**STORE)
    assert np.array_equal(ref.shard_bytes, port.shard_bytes)
    assert np.array_equal(ref.item_sizes(), port.item_sizes())
    for sid in (0, 7, 63):
        assert np.array_equal(ref.read(sid), port.read(sid))


@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
def test_pipeline_batches_and_costs_equal_reference(cost_model):
    ref = RefPipeline(RefStore(**STORE), cost_model=cost_model, **PIPE)
    port = PackedDataPipeline(ShardStore(**STORE), cost_model=cost_model,
                              device="cpu", **PIPE)
    for _ in range(40):
        a, b = next(ref), next(port)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _same_costs(ref.cache.costs, port.cache.costs)
    assert port.telemetry.batches == ref.telemetry.batches == 40
    assert port.telemetry.shards_fetched == ref.telemetry.shards_fetched
    assert np.array_equal(port.cache.partition.clique_of,
                          ref.cache.partition.clique_of)


def test_pipeline_resumable():
    store = ShardStore(n_shards=32, shard_tokens=256, vocab=100, n_domains=4)
    p1 = PackedDataPipeline(store, batch_rows=4, seq_len=32, seed=5,
                            device="cpu")
    seq = [next(p1) for _ in range(6)]
    p2 = PackedDataPipeline(store, batch_rows=4, seq_len=32, seed=5,
                            device="cpu")
    for _ in range(3):
        next(p2)
    p3 = PackedDataPipeline(store, batch_rows=4, seq_len=32, seed=5,
                            device="cpu")
    p3.load_state_dict({"step": 3})
    for i in range(3):
        assert np.array_equal(next(p2), seq[3 + i])
        assert np.array_equal(next(p3), seq[3 + i])
    # a rewind restarts the cost accounting; a forward jump keeps it
    cache = p2.cache
    p2.load_state_dict({"step": 2})
    assert p2.cache is not cache and p2.cache.now == -np.inf
    p3.load_state_dict(p3.state_dict())
    batcher = TokenBatcher(p3, accum=2, microbatch=2)
    batch = next(batcher)
    assert batch["tokens"].shape == (2, 2, 32)
    assert np.array_equal(batch["tokens"][..., 1:], batch["labels"][..., :-1])


def test_pipeline_live_backend_equals_session():
    def run(backend):
        p = PackedDataPipeline(ShardStore(**STORE), backend=backend,
                               device="cpu", **PIPE)
        return p, [next(p) for _ in range(40)]

    p1, o1 = run("session")
    p2, o2 = run("live")
    for x, y in zip(o1, o2):               # token stream is backend-blind
        assert np.array_equal(x, y)
    p2.cache.drain()
    _same_costs(p1.cache.costs, p2.cache.costs)


# ---------------------------------------------------------------------------
# the expert cache
# ---------------------------------------------------------------------------
def _observations(seed, steps, n_experts=32, groups=4):
    """Co-activated experts: fixed groups of 8, one hot."""
    rng = np.random.default_rng(seed)
    grp = [np.arange(8 * g, 8 * g + 8) % n_experts for g in range(groups)]
    out = []
    for _ in range(steps):
        g = grp[int(rng.integers(0, groups) if rng.random() < 0.3 else 0)]
        out.append((rng.choice(g, size=(4, 2)), int(rng.integers(0, 4))))
    return out


def test_expert_cache_savings_equal_reference():
    ref = RefManager(n_experts=32, n_hosts=4, t_cg=16.0)
    port = ExpertCacheManager(n_experts=32, n_hosts=4, t_cg=16.0,
                              device="cpu")
    for topk, host in _observations(0, 400):
        ref.observe(topk, host=host)
        port.observe(topk, host=host)
    rs, ps = ref.stats(), port.stats()
    assert ps.akpc_total < ps.nopack_total and len(ps.cliques) > 0
    assert np.isclose(ps.akpc_total, rs.akpc_total, rtol=RTOL)
    assert np.isclose(ps.nopack_total, rs.nopack_total, rtol=RTOL)
    assert ps.cliques == rs.cliques
    assert ps.n_observations == rs.n_observations
    assert np.isclose(ps.saving_pct, rs.saving_pct, rtol=1e-6)


def test_expert_cache_failover_through_a_snapshot():
    rng = np.random.default_rng(7)
    obs = [(rng.choice(8, size=(3, 2)), int(rng.integers(0, 2)))
           for _ in range(120)]

    def mk():
        return ExpertCacheManager(n_experts=16, n_hosts=2, t_cg=8.0,
                                  device="cpu")

    primary = mk()
    for topk, host in obs[:60]:
        primary.observe(topk, host=host)
    standby = mk()
    standby.restore(primary.snapshot())
    for mgr in (primary, standby):
        for topk, host in obs[60:]:
            mgr.observe(topk, host=host)
    assert standby.session.costs.as_dict() == primary.session.costs.as_dict()
    assert standby.cliques() == primary.cliques()
    assert standby.stats().nopack_total == primary.stats().nopack_total


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_expert_cache_snapshot_crosses_packages(direction):
    obs = _observations(3, 160, n_experts=16)
    kw = dict(n_experts=16, n_hosts=4, t_cg=8.0)
    src = (RefManager(**kw) if direction == "reference_to_port"
           else ExpertCacheManager(device="cpu", **kw))
    dst = (ExpertCacheManager(device="cpu", **kw)
           if direction == "reference_to_port" else RefManager(**kw))
    for topk, host in obs[:80]:
        src.observe(topk, host=host)
    dst.restore(src.snapshot())
    for mgr in (src, dst):
        for topk, host in obs[80:]:
            mgr.observe(topk, host=host)
    sa, sb = src.stats(), dst.stats()
    assert np.isclose(sa.akpc_total, sb.akpc_total, rtol=RTOL)
    assert np.isclose(sa.nopack_total, sb.nopack_total, rtol=RTOL)
    assert sa.cliques == sb.cliques
    assert sa.n_observations == sb.n_observations


def test_expert_cache_live_backend_equals_session():
    def run(backend):
        rng = np.random.default_rng(7)
        mgr = ExpertCacheManager(n_experts=16, n_hosts=4, t_cg=8.0,
                                 backend=backend, device="cpu")
        for _ in range(120):
            mgr.observe(rng.integers(0, 16, size=(32, 2)),
                        host=int(rng.integers(0, 4)))
        return mgr

    a, b = run("session"), run("live")
    sa, sb = a.stats(), b.stats()          # stats() drains the live engine
    assert np.isclose(sa.akpc_total, sb.akpc_total, rtol=RTOL)
    assert sa.nopack_total == sb.nopack_total
    assert sa.cliques == sb.cliques

    # checkpoints cross the backends: live -> session
    standby = ExpertCacheManager(n_experts=16, n_hosts=4, t_cg=8.0,
                                 device="cpu")
    standby.restore(b.snapshot())
    rng = np.random.default_rng(11)
    obs = [(rng.integers(0, 16, size=(32, 2)), int(rng.integers(0, 4)))
           for _ in range(60)]
    for mgr in (b, standby):
        for topk, host in obs:
            mgr.observe(topk, host=host)
    assert np.isclose(b.stats().akpc_total, standby.stats().akpc_total,
                      rtol=RTOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32])
def test_packed_tables_equal_reference_bitwise(dtype):
    ref = RefManager(n_experts=12, n_hosts=1, t_cg=4.0)
    port = ExpertCacheManager(n_experts=12, n_hosts=1, t_cg=4.0,
                              device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(40):
        topk = rng.choice(np.arange(6), size=(2, 2))
        ref.observe(topk, host=0)
        port.observe(topk, host=0)
    assert port.cliques() and port.cliques() == ref.cliques()
    w = (rng.normal(size=(12, 3, 5)) * 100).astype(dtype)
    table, where = port.packed_tables(w)
    rtable, rwhere = ref.packed_tables(w)
    assert table.dtype == rtable.dtype and table.shape == rtable.shape
    assert np.array_equal(table, rtable) and np.array_equal(where, rwhere)
    for e in range(12):
        ci, slot = where[e]
        assert np.array_equal(table[ci, slot], w[e])


def test_unknown_backend_refused():
    with pytest.raises(ValueError, match="backend"):
        ExpertCacheManager(8, 2, backend="bogus", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        PackedDataPipeline(ShardStore(8), batch_rows=2, seq_len=8,
                           backend="bogus", device="cpu")
    with pytest.raises(ValueError, match="expert_bytes"):
        ExpertCacheManager(8, 2, expert_bytes=np.ones(3), device="cpu")
