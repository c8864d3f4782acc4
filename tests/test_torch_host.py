"""The port's copied host layer against its source in ``repro``, and its seams.

* traces: ``synth_trace`` / ``paper_trace`` give the same arrays at a seed;
* schedule: ``build_cgm_schedule``, ``cgm_spec``, ``hot_capacity`` and
  ``cost_spec`` equal the JAX package's host functions;
* imports: ``repro_torch`` and ``chip_smoke`` load neither jax nor repro;
* routing: entry points default to CUDA and raise without it; ``learned``
  (once the one policy not ported) takes the host schedule.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import cgm_jax as ref_cgm
from repro.core import engine_jax as ref_engine_jax
from repro.core import get_policy as ref_get_policy
from repro.core.crm import hot_items_of_window as ref_hot_items
from repro.core.cost import get_cost_model as ref_get_cost_model
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import paper_trace as ref_paper_trace
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.core import (
    CacheEnvironment,
    CostParams,
    get_cost_model,
    get_policy,
    run_policy,
)
from repro_torch.core import cgm_schedule
from repro_torch.core.crm import hot_items_of_window
from repro_torch.core.state_layout import StateLayout
from repro_torch.core.replay import TorchReplayEngine, cost_spec
from repro_torch.traces import SynthConfig, paper_trace, synth_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRACE_KW = [
    dict(kind="netflix", n_items=48, n_servers=6, n_requests=900, t_max=9.0,
         bundle_cover=1.0, bundle_zipf=0.7, seed=5),
    dict(kind="spotify", n_items=500, n_servers=30, n_requests=3000,
         seed=2, size_dist="lognormal", server_affinity=3),
    dict(kind="netflix", n_items=100, n_servers=10, n_requests=2000,
         seed=4, size_dist="pareto", load_profile="flash_crowd"),
]


def _same_trace(a, b):
    assert np.array_equal(a.times, b.times)
    assert np.array_equal(a.servers, b.servers)
    assert np.array_equal(a.items, b.items)
    assert (a.n, a.m, a.name) == (b.n, b.m, b.name)
    assert (a.sizes is None) == (b.sizes is None)
    if a.sizes is not None:
        assert np.array_equal(a.sizes, b.sizes)


@pytest.mark.parametrize("kw", TRACE_KW)
def test_synth_trace_equal(kw):
    _same_trace(synth_trace(SynthConfig(**kw)),
                ref_synth_trace(RefSynthConfig(**kw)))


@pytest.mark.parametrize("kind", ["netflix", "spotify"])
def test_paper_trace_equal(kind):
    _same_trace(paper_trace(kind, 5000, seed=3),
                ref_paper_trace(kind, 5000, seed=3))


@pytest.mark.parametrize("batch_size", [None, 7, 300])
@pytest.mark.parametrize("kw", TRACE_KW[:2])
def test_cgm_schedule_equal(kw, batch_size):
    ref_tr = ref_synth_trace(RefSynthConfig(**kw))
    tr = synth_trace(SynthConfig(**kw))
    dims = [(0.1, False), (0.5, True)]
    got = cgm_schedule.build_cgm_schedule(
        tr, 0.37, uses_sizes=True, batch_size=batch_size, hot_dims=dims)
    want = ref_cgm.build_cgm_schedule(
        ref_tr, 0.37, uses_sizes=True, batch_size=batch_size, hot_dims=dims)
    for f in ("n", "m", "nb", "B", "d", "n_requests", "n_item_requests",
              "win_start", "boundary_hit", "next_cg", "h", "wcap",
              "win_rows", "win_slots"):
        assert getattr(got, f) == getattr(want, f), f
    assert np.array_equal(got.boundary_steps, want.boundary_steps)
    for k, v in want.xs.items():
        assert np.array_equal(got.xs[k], v), k
    pad = {"nb": got.nb + 5, "B": got.B + 32, "d": got.d, "h": got.h + 32}
    p_got = cgm_schedule.pad_cgm_schedule(got, pad)
    p_want = ref_cgm.pad_cgm_schedule(want, pad)
    assert (p_got.nb, p_got.B, p_got.h, p_got.wcap) == \
        (p_want.nb, p_want.B, p_want.h, p_want.wcap)
    for k, v in p_want.xs.items():
        assert np.array_equal(p_got.xs[k], v), k
    assert cgm_schedule._max_window_requests(tr, 0.37) == \
        ref_cgm._max_window_requests(ref_tr, 0.37)


@pytest.mark.parametrize("n,slots", [(60, 500), (10_000, 22_000), (1, 1),
                                     (4096, 300)])
def test_hot_capacity_equal(n, slots):
    for dims in ([(0.1, False)], [(0.5, True)], [(0.1, False), (1.0, False)]):
        assert cgm_schedule.hot_capacity(n, slots, dims) == \
            ref_cgm.hot_capacity(n, slots, dims)


@pytest.mark.parametrize("name", ["akpc", "akpc_no_acm", "akpc_base"])
@pytest.mark.parametrize("params", [dict(), dict(theta=0.3, gamma=0.6,
                                                 omega=3)])
def test_cgm_spec_equal(name, params):
    pol = get_policy(name, params=CostParams(**params), top_frac_of="catalog")
    ref = ref_get_policy(name, params=RefParams(**params),
                         top_frac_of="catalog")
    got = cgm_schedule.cgm_spec(pol.config, pol.config.params, 77)
    want = ref_cgm.cgm_spec(ref.config, ref.config.params, 77)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == v and got[k].dtype == v.dtype, k


@pytest.mark.parametrize("model", ["table1", "tiered", "heterogeneous"])
def test_cost_spec_equal(model):
    kw = dict(price_sigma=0.4, size_sigma=0.3, seed=9)
    env = CacheEnvironment.skewed(50, 7, CostParams(), **kw)
    ref_env = RefEnv.skewed(50, 7, RefParams(), **kw)
    got, key = cost_spec(get_cost_model(model, env), env)
    want, ref_key = ref_engine_jax.cost_spec(
        ref_get_cost_model(model, ref_env), ref_env)
    assert key == ref_key
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(np.asarray(got[k]), np.asarray(v)), k


@pytest.mark.parametrize("of", ["window", "catalog"])
def test_hot_items_of_window_equal(of):
    rng = np.random.default_rng(4)
    for n, frac in ((60, 0.1), (500, 0.37), (7, 1.0)):
        items = rng.integers(-1, n, size=(300, 5))
        assert np.array_equal(hot_items_of_window(items, n, frac, of),
                              ref_hot_items(items, n, frac, of))


def test_state_layout_dense_only():
    lay = StateLayout.resolve(None)
    assert lay.state_dims(10, 3) == (11, 3) and lay.dump_row(10) == 10
    assert lay.supports_device_cgm(10, 3)
    # the bucketed and row_sharded layouts are ported; a bare
    # "row_sharded" names no shard count and raises, as the reference's
    assert StateLayout.resolve("bucketed").state_dims(10, 3) == (1025, 256)
    assert TorchReplayEngine(5, 2, device="cpu",
                             layout="bucketed").layout.kind == "bucketed"
    sharded = TorchReplayEngine(
        5, 2, device="cpu", layout=StateLayout(kind="row_sharded", shards=4))
    assert sharded.layout.row_shards == 4
    assert sharded.layout.state_dims(5, 2) == (8, 2)
    assert not sharded.layout.supports_device_cgm(5, 2)
    with pytest.raises(ValueError, match="needs a mesh"):
        StateLayout.resolve("row_sharded")


def test_install_partition_equal():
    """The host install (initial partitions) translates state as the
    numpy engine does: matched rows kept, changed rows min-merged, new
    cliques seeded from the window."""
    from repro.core.cliques import CliquePartition as RefPartition
    from repro.core.engine import ReplayEngine as RefEngine

    from repro_torch.convert import state_from_arrays
    from repro_torch.core import CliquePartition, ReplayEngine

    ref_trace = ref_synth_trace(RefSynthConfig(**TRACE_KW[0]))
    pol = ref_get_policy("akpc", t_cg=0.73, top_frac=0.5)
    pol.bind(ref_trace.n, ref_trace.m)
    ref = RefEngine(ref_trace.n, ref_trace.m)
    ref.replay(ref_trace.slice(0, 600), clique_generator=pol.on_window,
               t_cg=0.73)
    eng = ReplayEngine(ref_trace.n, ref_trace.m)
    st = ref.state
    eng.state = state_from_arrays(st.partition.clique_of, st.E, st.anchor,
                                  st.m)
    rng = np.random.default_rng(0)
    perm = rng.permutation(ref_trace.n)
    groups = [tuple(sorted(perm[i:i + 3].tolist())) for i in range(0, 24, 3)]
    groups += [c for c in st.partition.cliques if len(c) > 1
               and not set(c) & set(perm[:24].tolist())]
    w_it, w_sv = ref_trace.items[500:600], ref_trace.servers[500:600]
    now = float(ref_trace.times[600])
    ref.install_partition(RefPartition.from_cliques(ref_trace.n, groups),
                          now, w_it, w_sv)
    eng.install_partition(CliquePartition.from_cliques(ref_trace.n, groups),
                          now, w_it, w_sv)
    assert np.array_equal(eng.state.E, ref.state.E)
    assert np.array_equal(eng.state.anchor, ref.state.anchor)
    assert (eng.state.E > 0).any()
    assert np.array_equal(eng._sizes, ref._sizes)


def test_port_imports_neither_jax_nor_repro():
    """Import every module of the port and chip_smoke's imports in a fresh
    interpreter; no jax and no repro module may be loaded."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "sys.path.insert(0, {root!r})\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith"
        "('jax.') or k.startswith('jaxlib') or k == 'repro' or k.startswith"
        "('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.core.cgm' in sys.modules\n"
    ).format(root=str(ROOT))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device works here")
    trace = synth_trace(SynthConfig(**TRACE_KW[0]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_policy(get_policy("akpc", t_cg=0.73), trace)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchReplayEngine(trace.n, trace.m)


@pytest.mark.parametrize("name", ["learned"])
def test_host_schedule_policies_raise_not_implemented(name):
    """``learned`` no longer raises: it replays through the host schedule."""
    trace = synth_trace(SynthConfig(**TRACE_KW[0]))
    res = run_policy(get_policy(name, t_cg=0.73), trace, device="cpu")
    assert res.policy == name
    assert res.loop_stats["path"] == "host_schedule"


def test_uniform_heterogeneous_prices_run_on_device_path():
    """Heterogeneous pricing with one price everywhere has a uniform dt,
    which the device path admits; it matches the table1 run there."""
    trace = synth_trace(SynthConfig(**TRACE_KW[0]))
    kw = dict(t_cg=0.73, top_frac=0.5)
    het = run_policy(get_policy("akpc", cost_model="heterogeneous", **kw),
                     trace, device="cpu")
    t1 = run_policy(get_policy("akpc", **kw), trace, device="cpu")
    assert np.array_equal(het.state.E, t1.state.E)
    assert np.isclose(het.total, t1.total, rtol=1e-9)
