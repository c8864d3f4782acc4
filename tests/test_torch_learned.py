"""The port's learned keep-or-not policy and its trainer against the reference.

Inputs are numpy, from seeds; the reference runs its numpy paths, or its
jnp twins under ``jax.enable_x64(True)``.  Tolerances, as stated in each
test:

* features and forward: the numpy halves bit for bit; the torch twins
  against the jnp twins at 1e-12 relative (f64 round-off);
* warm start: the untrained ``learned`` policy equals the port's ``ttl``
  exactly and the reference's numpy ``ttl`` at 1e-9;
* ``hindsight_windows``: ``(X, y, w)`` bit for bit, table1 and
  heterogeneous;
* AdamW: the schedule bit for bit on the warmup steps and within one f32
  ulp after (XLA's f32 ``cos`` on the CPU is not correctly rounded, and
  torch's rounds differently); one update bit for bit when the gradient
  norm is under the clip, and at 1e-6 relative when clipping (the two
  libraries sum a leaf's squares in another order);
* the step loop against the reference's compiled ``_trainer`` on the same
  padded inputs, indices and converted warm tree: every leaf within 1e-5
  of its largest magnitude, the losses at 1e-6, and identical keep
  masks;
* serving reference-trained params through the port's replays: costs at
  1e-9, integer counters exact; snapshots cross the packages;
* the fig11 gate in miniature.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import get_policy as ref_get_policy
from repro.core import run_policy as ref_run_policy
from repro.core.session import CacheSession as RefSession
from repro.learned import features_jnp as ref_features_jnp
from repro.learned import features_np as ref_features_np
from repro.learned import hindsight_windows as ref_hindsight
from repro.learned import init_params as ref_init_params
from repro.learned import init_stats as ref_init_stats
from repro.learned import update_stats as ref_update_stats
from repro.learned import warm_params as ref_warm_params
from repro.learned.model import LearnedParams as RefLearnedParams
from repro.learned.model import forward_jnp as ref_forward_jnp
from repro.learned.model import forward_np as ref_forward_np
from repro.learned.train import TrainConfig as RefTrainConfig
from repro.learned.train import _bucket as ref_bucket
from repro.learned.train import _trainer as ref_trainer
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.adamw import cosine_schedule as ref_cosine
from repro.traces import SynthConfig, synth_trace

from repro_torch.bench import fig11
from repro_torch.convert import learned_params_from_tree, trace_from_arrays
from repro_torch.core import (
    CacheEnvironment,
    CacheSession,
    CostParams,
    get_policy,
    run_policy,
)
from repro_torch.learned import (
    FEATURE_NAMES,
    FEATURE_SCHEMA_VERSION,
    LearnedParams,
    LearnedPolicy,
    Scorer,
    TrainConfig,
    features_np,
    features_torch,
    forward_np,
    forward_torch,
    hindsight_windows,
    init_params,
    init_stats,
    load_learned_params,
    save_learned_params,
    train_policy,
    update_stats,
    warm_params,
)
from repro_torch.learned.train import adamw_config, train_steps
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    tree_leaves,
    tree_map,
)
from repro_torch.serving import LiveServingEngine

PARAMS = dict(rho=4.0)             # keep/evict economics bite
T_CG = 12.0
COUNTERS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
            "items_transferred")
FLOATS = ("transfer", "caching", "keepalive_rent", "total")
#: the trainer's parity bars (f32 moments; the libraries round f32 pow,
#: cos and reductions differently): per leaf relative to its largest
#: magnitude, and for the losses
TRAIN_LEAF_RTOL = 1e-5
TRAIN_LOSS_RTOL = 1e-6
#: the jnp twins against the torch twins at f64
TWIN_RTOL = 1e-12


def _ref_trace(n_requests=2500, seed=3, profile="regime_shift",
               size_dist="unit"):
    """``tests/test_learned.py``'s trace."""
    return synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=12, n_requests=n_requests,
        t_max=0.1 * n_requests, bundle_cover=1.0, bundle_zipf=0.7,
        server_affinity=2, load_profile=profile,
        load_strength=0.25 if profile == "regime_shift" else 0.8,
        load_peak=0.4, seed=seed, size_dist=size_dist))


def _port(tr):
    return trace_from_arrays(tr.items, tr.servers, tr.times, tr.n, tr.m,
                             sizes=tr.sizes)


def _envs(cost_model, tr):
    """(reference env, port env); None under table1."""
    if cost_model == "table1":
        return None, None
    renv = RefEnv.resolve(RefEnv.skewed(tr.n, tr.m, RefParams(**PARAMS),
                                        price_sigma=0.8, seed=1),
                          tr, RefParams(**PARAMS))
    penv = CacheEnvironment.resolve(
        CacheEnvironment.skewed(tr.n, tr.m, CostParams(**PARAMS),
                                price_sigma=0.8, seed=1),
        _port(tr), CostParams(**PARAMS))
    return renv, penv


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(lp):
    """A reference LearnedParams as the port's."""
    return learned_params_from_tree(_np_tree(lp.tree()))


def _same_costs(a, b, exact=False):
    da = a if isinstance(a, dict) else a.as_dict()
    db = b if isinstance(b, dict) else b.as_dict()
    for f in COUNTERS:
        assert da[f] == db[f], f"{f}: {da[f]} != {db[f]}"
    for f in FLOATS:
        if exact:
            assert da[f] == db[f], f"{f}: {da[f]!r} != {db[f]!r}"
        else:
            assert np.isclose(da[f], db[f], rtol=1e-9, atol=1e-9), \
                f"{f}: {da[f]!r} != {db[f]!r}"


def _prepare(tr, env, cost_model, cfg):
    """The reference ``train_policy``'s host preparation: its examples,
    warm tree, padded arrays and minibatch indices."""
    params = RefParams(**PARAMS)
    X, y, wt = ref_hindsight(tr, env, T_CG, params=params,
                             cost_model=cost_model)
    lp = ref_warm_params(params.lam, params.mu, T_CG, cfg.keep_factor,
                         seed=cfg.seed, d=cfg.d, d_ff=cfg.d_ff)
    n = X.shape[0]
    lp.mu = X.mean(axis=0)
    lp.sd = np.maximum(X.std(axis=0), 1e-9)
    n_pad = ref_bucket(n, cfg.pad_bucket)
    Xp = np.zeros((n_pad, X.shape[1]))
    yp, wp = np.zeros(n_pad), np.zeros(n_pad)
    Xp[:n], yp[:n], wp[:n] = X, y, wt
    idx = np.random.default_rng(cfg.seed).choice(
        n, size=(cfg.steps, cfg.batch), p=wt / wt.sum()).astype(np.int32)
    return X, lp, Xp, yp, wp, idx


def _ref_acfg(cfg):
    return RefAdamWConfig(
        lr=cfg.lr, weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm,
        warmup_steps=max(int(cfg.warmup_frac * cfg.steps), 1),
        total_steps=cfg.steps, min_lr_frac=cfg.min_lr_frac,
        warmup_floor=cfg.warmup_floor)


def _ref_train(tr, env=None, cost_model="table1", steps=60, batch=128):
    """The reference ``train_policy`` (its host preparation, then its
    compiled ``_trainer`` under x64): (LearnedParams, losses, final,
    prepared inputs)."""
    cfg = RefTrainConfig(steps=steps, batch=batch)
    X, lp, Xp, yp, wp, idx = _prepare(tr, env, cost_model, cfg)
    fn = ref_trainer(Xp.shape[0], X.shape[1], cfg.steps, cfg.batch,
                     _ref_acfg(cfg))
    with jax.enable_x64(True):
        w_fin, losses, final = fn(lp.w, lp.mu, lp.sd, Xp, yp, wp, idx)
        out = RefLearnedParams(schema=lp.schema, mu=lp.mu, sd=lp.sd,
                               w=_np_tree(w_fin))
        return out, np.asarray(losses), float(final), (X, lp, Xp, yp, wp,
                                                       idx)


@pytest.fixture(scope="module")
def trace():
    return _ref_trace()


@pytest.fixture(scope="module")
def trained(trace):
    return _ref_train(trace)


# ---------------------------------------------------------------------------
# features and model
# ---------------------------------------------------------------------------
def _feature_inputs(seed=0, n=40):
    rng = np.random.default_rng(seed)
    dt, t_cg = 4.0, 12.0
    ref_stats, stats = ref_init_stats(n, dt), init_stats(n, dt)
    for w in range(3):
        counts = rng.poisson(1.5, n).astype(np.float64)
        ref_update_stats(ref_stats, counts, 10.0 * (w + 1), t_cg)
        update_stats(stats, counts, 10.0 * (w + 1), t_cg)
    for k in ref_stats:
        assert np.array_equal(ref_stats[k], stats[k])
    co_deg = rng.integers(0, 6, n).astype(np.float64)
    sizes = np.exp(rng.normal(0, 0.5, n))
    csz = rng.integers(1, 5, n).astype(np.float64)
    return counts, co_deg, stats, sizes, csz, 30.0, dt, t_cg


def test_features_np_equals_reference_bitwise():
    args = _feature_inputs()
    got = features_np(*args)
    assert got.shape == (40, len(FEATURE_NAMES))
    assert np.array_equal(got, ref_features_np(*args))


def test_features_torch_matches_features_jnp():
    counts, co_deg, stats, sizes, csz, now, dt, t_cg = _feature_inputs(1)
    with jax.enable_x64(True):
        want = np.asarray(ref_features_jnp(counts, co_deg, stats, sizes, csz,
                                           now, dt, t_cg))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float64))

    got = features_torch(t(counts), t(co_deg),
                         {k: t(v) for k, v in stats.items()}, t(sizes),
                         t(csz), now, dt, t_cg)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=TWIN_RTOL,
                               atol=TWIN_RTOL)


def test_forward_np_equals_reference_bitwise():
    rng = np.random.default_rng(1)
    ref = ref_init_params(seed=7)
    ref.w["w_out"] = rng.normal(0, 1, ref.w["w_out"].shape)
    ref.w["w_lin"] = rng.normal(0, 1, ref.w["w_lin"].shape)
    ref.mu = rng.normal(0, 1, ref.mu.shape)
    lp = _to_port(ref)
    X = rng.normal(0, 1, (50, lp.n_features))
    assert np.array_equal(forward_np(lp, X), ref_forward_np(ref, X))


def test_forward_torch_matches_forward_jnp():
    rng = np.random.default_rng(2)
    ref = ref_init_params(seed=7)
    ref.w["w_out"] = rng.normal(0, 1, ref.w["w_out"].shape)
    X = rng.normal(0, 3, (50, ref.n_features))
    with jax.enable_x64(True):
        want = np.asarray(ref_forward_jnp(ref.w, ref.mu, ref.sd, X))
    lp = _to_port(ref)
    w = tree_map(torch.from_numpy, lp.w)
    got = forward_torch(w, torch.from_numpy(lp.mu), torch.from_numpy(lp.sd),
                        torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), want, rtol=TWIN_RTOL,
                               atol=TWIN_RTOL)
    scorer = Scorer(lp, device="cpu")
    assert torch.equal(scorer(torch.from_numpy(X)), got)


def test_forwards_refuse_schema_mismatch():
    lp = init_params(seed=0)
    lp.schema = FEATURE_SCHEMA_VERSION + 1
    with pytest.raises(ValueError, match="schema"):
        forward_np(lp, np.zeros((3, lp.n_features)))
    with pytest.raises(ValueError, match="schema"):
        Scorer(lp, device="cpu")


def test_scorer_holds_the_tree_under_its_names():
    lp = warm_params(1.0, 1.0, T_CG)
    scorer = Scorer(lp, device="cpu")
    names = dict(scorer.named_parameters())
    assert set(names) == {"w_lin", "b", "w_in", "w_out", "trunk.wi",
                          "trunk.wg", "trunk.wo"}
    assert all(p.dtype == torch.float64 for p in names.values())
    back = scorer.to_params()
    for (pa, a), (pb, b) in zip(tree_leaves(lp.w), tree_leaves(back.w)):
        assert pa == pb and np.array_equal(a, b)
    ref = ref_warm_params(1.0, 1.0, T_CG)
    for (pa, a), (pb, b) in zip(tree_leaves(_np_tree(ref.w)),
                                tree_leaves(lp.w)):
        assert pa == pb and a.shape == b.shape
    assert np.array_equal(lp.w["w_lin"], ref.w["w_lin"])
    assert lp.w["b"] == ref.w["b"]
    assert not lp.w["w_out"].any()


def test_init_params_from_a_generator():
    a = init_params(seed=3)
    b = init_params(generator=torch.Generator().manual_seed(3))
    c = init_params(seed=4)
    for (_, x), (_, y), (_, z) in zip(tree_leaves(a.w), tree_leaves(b.w),
                                      tree_leaves(c.w)):
        assert np.array_equal(x, y) and x.dtype == np.float64
    assert not np.array_equal(a.w["w_in"], c.w["w_in"])


# ---------------------------------------------------------------------------
# warm start and labels
# ---------------------------------------------------------------------------
def test_warm_start_equals_ttl(trace):
    port = _port(trace)
    ttl = run_policy(get_policy("ttl", params=CostParams(**PARAMS),
                                t_cg=T_CG), port, device="cpu")
    got = run_policy(get_policy("learned", params=CostParams(**PARAMS),
                                t_cg=T_CG), port, device="cpu")
    assert got.policy == "learned"
    assert isinstance(get_policy("learned"), LearnedPolicy)
    _same_costs(ttl.costs, got.costs, exact=True)
    ref = ref_run_policy(ref_get_policy("ttl", params=RefParams(**PARAMS),
                                        t_cg=T_CG), trace)
    _same_costs(ref.costs, got.costs)


@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
def test_hindsight_windows_equal_reference_bitwise(cost_model):
    tr = _ref_trace(size_dist="lognormal")
    renv, penv = _envs(cost_model, tr)
    want = ref_hindsight(tr, renv, T_CG, params=RefParams(**PARAMS),
                         cost_model=cost_model)
    got = hindsight_windows(_port(tr), penv, T_CG,
                            params=CostParams(**PARAMS),
                            cost_model=cost_model)
    assert got[0].shape[0] > 0 and got[2].sum() > 0
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
ACFG = dict(lr=3e-2, weight_decay=1e-4, clip_norm=1.0, warmup_steps=6,
            total_steps=60, min_lr_frac=0.05, warmup_floor=0.1)


def test_cosine_schedule_equals_reference():
    steps = np.arange(0, ACFG["total_steps"] + 1, dtype=np.int32)
    with jax.enable_x64(True):
        want = np.asarray(ref_cosine(RefAdamWConfig(**ACFG), steps))
    got = cosine_schedule(AdamWConfig(**ACFG),
                          torch.from_numpy(steps)).numpy()
    assert got.dtype == want.dtype == np.float32
    warm = steps < ACFG["warmup_steps"]
    assert np.array_equal(got[warm], want[warm])
    assert (np.abs(got - want) <= np.spacing(want)).all()


def _warm_tree_and_grads(scale, seed):
    rng = np.random.default_rng(seed)
    ref = ref_warm_params(1.0, 1.0, T_CG)
    ref.w["w_out"] = rng.normal(0, 0.1, ref.w["w_out"].shape)
    tree = _np_tree(ref.w)
    grads = jax.tree.map(
        lambda a: np.asarray(rng.normal(0, scale, np.shape(a))), tree)
    return tree, grads


@pytest.mark.parametrize("scale,rtol", [(0.01, 0.0), (3.0, 1e-6)],
                         ids=["unclipped", "clipped"])
def test_adamw_update_equals_reference(scale, rtol):
    tree, grads = _warm_tree_and_grads(scale, seed=4)
    with jax.enable_x64(True):
        jt = jax.tree.map(jax.numpy.asarray, tree)
        st = ref_adamw_init(jt)
        wp, wst, wstats = ref_adamw_update(
            RefAdamWConfig(**ACFG), jax.tree.map(jax.numpy.asarray, grads),
            st, jt)
        want = {"p": _np_tree(wp), "m": _np_tree(wst["m"]),
                "v": _np_tree(wst["v"])}
        want_norm = float(wstats["grad_norm"])
    pt = tree_map(torch.from_numpy, learned_params_from_tree(
        {"schema": 1, "mu": 0, "sd": 1, "w": tree}).w)
    gp, gst, gstats = adamw_update(
        AdamWConfig(**ACFG), tree_map(torch.from_numpy, grads),
        adamw_init(pt), pt)
    got = {"p": gp, "m": gst["m"], "v": gst["v"]}
    assert (want_norm > ACFG["clip_norm"]) == (rtol > 0)
    assert int(gst["step"]) == 1
    for key in ("p", "m", "v"):
        for (pa, a), (pb, b) in zip(tree_leaves(want[key]),
                                    tree_leaves(got[key])):
            b = b.numpy()
            assert pa == pb and a.dtype == b.dtype, (key, pa)
            if rtol == 0.0:
                assert np.array_equal(a, b), (key, pa)
            else:
                np.testing.assert_allclose(b, a, rtol=rtol, atol=0.0)
    np.testing.assert_allclose(float(gstats["grad_norm"]), want_norm,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def test_step_loop_matches_reference_trainer(trained):
    """The port's step loop against the reference's ``_trainer``: the same
    padded inputs, indices and converted warm tree."""
    want, want_losses, want_final, (X, lp0, Xp, yp, wp, idx) = trained
    scorer = Scorer(_to_port(lp0), device="cpu")
    losses, final = train_steps(
        scorer, torch.from_numpy(Xp), torch.from_numpy(yp),
        torch.from_numpy(wp), torch.from_numpy(idx),
        adamw_config(TrainConfig(steps=60, batch=128)))
    got = scorer.to_params()
    for (pa, a), (pb, b) in zip(tree_leaves(want.w), tree_leaves(got.w)):
        assert pa == pb
        assert np.abs(a - b).max() <= TRAIN_LEAF_RTOL * np.abs(a).max(), pa
    np.testing.assert_allclose(losses.numpy(), want_losses,
                               rtol=TRAIN_LOSS_RTOL)
    assert abs(float(final) - want_final) <= TRAIN_LOSS_RTOL * want_final
    assert np.array_equal(forward_np(got, X) >= 0,
                          ref_forward_np(want, X) >= 0)


def test_train_degenerate_trace_returns_warm_start():
    tiny = _port(_ref_trace(n_requests=5))
    lp = train_policy(tiny, t_cg=1e9, params=CostParams(**PARAMS),
                      device="cpu")
    ref = warm_params(1.0, 1.0, 1e9, 1.0)
    for (_, a), (_, b) in zip(tree_leaves(lp.w), tree_leaves(ref.w)):
        assert np.array_equal(a, b)
    assert np.array_equal(lp.mu, ref.mu) and np.array_equal(lp.sd, ref.sd)


def test_train_policy_runs_the_step_loop(trace):
    """``train_policy`` on the CPU: the host preparation, then the step
    loop from the port's own warm start."""
    cfg = TrainConfig(steps=20, batch=64)
    lp = train_policy(_port(trace), t_cg=T_CG, params=CostParams(**PARAMS),
                      cfg=cfg, device="cpu")
    X, _, Xp, yp, wp, idx = _prepare(trace, None, "table1", cfg)
    start = warm_params(1.0, 1.0, T_CG)
    start.mu, start.sd = X.mean(axis=0), np.maximum(X.std(axis=0), 1e-9)
    assert np.array_equal(lp.mu, start.mu) and np.array_equal(lp.sd, start.sd)
    scorer = Scorer(start, device="cpu")
    train_steps(scorer, *(torch.from_numpy(a) for a in (Xp, yp, wp, idx)),
                adamw_config(cfg))
    for (_, a), (_, b) in zip(tree_leaves(lp.w),
                              tree_leaves(scorer.to_params().w)):
        assert np.array_equal(a, b)
    assert lp.w["w_out"].any()


# ---------------------------------------------------------------------------
# serving a trained policy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
def test_trained_policy_serves_like_reference(trace, trained, cost_model):
    tr = trace if cost_model == "table1" else _ref_trace(
        size_dist="lognormal")
    renv, penv = _envs(cost_model, tr)
    ref_lp = trained[0] if cost_model == "table1" else _ref_train(
        tr, renv, cost_model, steps=40, batch=64)[0]
    ref_pol = ref_get_policy(
        "learned", params=RefParams(**PARAMS), t_cg=T_CG, learned=ref_lp,
        env=renv, cost_model=cost_model)
    want = ref_run_policy(ref_pol, tr)
    pol = get_policy("learned", params=CostParams(**PARAMS), t_cg=T_CG,
                     learned=_to_port(ref_lp), env=penv,
                     cost_model=cost_model)
    got = run_policy(pol, _port(tr), device="cpu")
    _same_costs(want.costs, got.costs)
    assert got.n_windows == want.n_windows
    assert np.array_equal(pol.item_keep(), ref_pol.item_keep())


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_session_snapshot_crosses_packages(trace, trained, direction):
    ref_lp = trained[0]
    port = _port(trace)
    rs = RefSession(ref_get_policy("learned", params=RefParams(**PARAMS),
                                   t_cg=T_CG, learned=ref_lp),
                    trace.n, trace.m)
    ps = CacheSession(get_policy("learned", params=CostParams(**PARAMS),
                                 t_cg=T_CG, learned=_to_port(ref_lp)),
                      port.n, port.m, device="cpu")
    src, dst = (rs, ps) if direction == "reference_to_port" else (ps, rs)
    cut = trace.n_requests // 2 + 7
    src.feed(trace.items[:cut], trace.servers[:cut], trace.times[:cut])
    dst.restore(src.snapshot())
    assert np.array_equal(dst.policy.item_keep(), src.policy.item_keep())
    for s in (src, dst):
        s.feed(trace.items[cut:], trace.servers[cut:], trace.times[cut:])
    _same_costs(src.costs, dst.costs)
    assert np.array_equal(src.engine.state.E, dst.engine.state.E)
    assert np.array_equal(dst.policy.item_keep(), src.policy.item_keep())
    whole = RefSession(ref_get_policy("learned", params=RefParams(**PARAMS),
                                      t_cg=T_CG, learned=ref_lp),
                       trace.n, trace.m)
    whole.feed(trace.items, trace.servers, trace.times)
    _same_costs(whole.costs, dst.costs)


def test_live_engine_equals_session(trace, trained):
    port = _port(trace)

    def pol():
        return get_policy("learned", params=CostParams(**PARAMS), t_cg=T_CG,
                          learned=_to_port(trained[0]))

    ses = CacheSession(pol(), port.n, port.m, device="cpu")
    ses.feed_trace(port)
    eng = LiveServingEngine(pol(), port.n, port.m, chunk_size=512,
                            device="cpu")
    eng.feed(port.items, port.servers, port.times)
    eng.drain()
    _same_costs(ses.costs, eng.costs)
    assert np.array_equal(ses.engine.state.E, eng.session.engine.state.E)

    cut = port.n_requests // 2
    first = LiveServingEngine(pol(), port.n, port.m, chunk_size=512,
                              device="cpu")
    first.feed(port.items[:cut], port.servers[:cut], port.times[:cut])
    second = LiveServingEngine(pol(), port.n, port.m, chunk_size=512,
                               device="cpu").restore(first.snapshot())
    second.feed(port.items[cut:], port.servers[cut:], port.times[cut:])
    second.drain()
    _same_costs(eng.costs, second.costs, exact=True)
    assert np.array_equal(eng.session.engine.state.E,
                          second.session.engine.state.E)


def test_checkpoint_roundtrip_and_refusals(tmp_path, trained):
    lp = _to_port(trained[0])
    d = str(tmp_path / "ckpt")
    save_learned_params(lp, d, step=3)
    back = load_learned_params(d)
    assert back.schema == lp.schema and back.feature_names == FEATURE_NAMES
    for (_, a), (_, b) in zip(tree_leaves(lp.w), tree_leaves(back.w)):
        assert np.array_equal(a, b)
    assert np.array_equal(back.mu, lp.mu) and np.array_equal(back.sd, lp.sd)
    X = np.random.default_rng(5).normal(0, 1, (64, lp.n_features))
    assert np.array_equal(forward_np(back, X), forward_np(lp, X))

    stale = LearnedParams.from_tree(lp.tree())
    stale.schema = FEATURE_SCHEMA_VERSION + 7
    d2 = str(tmp_path / "stale")
    save_learned_params(stale, d2, step=0)
    with pytest.raises(ValueError, match="schema"):
        load_learned_params(d2)
    with pytest.raises(FileNotFoundError):
        load_learned_params(str(tmp_path / "nowhere"))


def test_fig11_gate_in_miniature():
    """Trained on seed 200, ``learned`` beats ``no_packing`` on the
    held-out regime-shift traces of seeds 101 and 102."""
    params = CostParams(**PARAMS)
    train_tr = fig11.stress_trace("regime_shift", 200, 2500)
    tcg = fig11.t_cg_for(train_tr, params)
    lp = train_policy(train_tr, t_cg=tcg, params=params, device="cpu")
    for seed in (101, 102):
        tr = fig11.stress_trace("regime_shift", seed, 2500)
        learned = run_policy(get_policy("learned", params=params, t_cg=tcg,
                                        learned=lp), tr, device="cpu").total
        nop = run_policy(get_policy("no_packing", params=params), tr,
                         device="cpu").total
        assert learned < nop, seed
    assert fig11.smoke("cpu") == 0
