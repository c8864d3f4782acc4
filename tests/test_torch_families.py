"""The port's remaining model families against ``repro.models``, on the CPU.

MLA (deepseek-v2), the Mamba-2 / Zamba2 hybrid over the chunked linear
attention (zamba2), xLSTM (xlstm) and the Whisper encoder-decoder
(whisper), at the smoke configs.  Inputs are made by numpy from a seed
and handed to both packages; whole models take the reference's
parameters (``model.init(PRNGKey(0))``) through
``convert.model_params_from_arrays`` (bf16 leaves upcast to f32 on the
way, which is exact).  Tolerances are ``tests/test_torch_models.py``'s:

* ``F32_TOL`` (2e-5 of the reference's largest magnitude) for the f32
  variants: f32 sums in other orders (``jnp.cumsum`` against
  ``torch.cumsum``, XLA's products against torch's) and XLA's f32
  transcendentals against torch's; argmax tokens must be equal;
* ``BF16_TOL`` (6e-2 of the largest magnitude) for bf16: every product,
  norm and residual rounds to 8 bits, and a value on a rounding boundary
  may round the other way in the other package;
* exact: layouts, cache trees, shapes and dtypes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import api as ref_api
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import linear_attn as ref_la
from repro.models import ssm as ref_ssm
from repro.models import xlstm as ref_xlstm
from repro.models.api import build_model as ref_build

from repro_torch import configs
from repro_torch.convert import cache_from_arrays, model_params_from_arrays
from repro_torch.models import api, attention, common, linear_attn, ssm, xlstm
from repro_torch.models.api import build_model

F32_TOL = 2e-5
BF16_TOL = 6e-2
FAMILIES = ["deepseek_v2_236b", "zamba2_1_2b", "xlstm_125m", "whisper_tiny"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread: at the smoke sizes every op is tiny,
    and under the parallel test run an op's thread team waits on cores the
    other workers hold (a test here ran ~50x slower on 8 loaded cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    """A reference pytree as numpy arrays, bf16 upcast to f32 (exact)."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if tree.dtype == jnp.bfloat16:
        tree = tree.astype(jnp.float32)
    return np.asarray(tree)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, tol, what=""):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max()) / scale
    assert gap <= tol, f"{what}: gap {gap} of max {scale} > {tol}"


def assert_tree_close(got, want, tol, what=""):
    """Every leaf of two cache trees of one structure within ``tol``, and
    the port's leaf in the reference's dtype."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(common.tree_leaves(got))
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        name = "/".join(k.key for k in path)
        assert str(node.dtype).split(".")[-1] == leaf.dtype.name, name
        assert_close(node, leaf, tol, f"{what} {name}")


def variant(cfg, f32: bool):
    if not f32:
        return cfg
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def pair(arch: str, f32: bool):
    """(reference model, its params, port model, its params) at the smoke
    config, the port's parameters converted from the reference's (built
    once a module: the tests only read them)."""
    rcfg = variant(ref_configs.get_smoke_config(arch), f32)
    tcfg = variant(configs.get_smoke_config(arch), f32)
    rm = ref_build(rcfg)
    rp = jax.jit(rm.init)(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = model_params_from_arrays(tcfg, np_tree(rp), device="cpu")
    return rm, rp, tm, tp


def jit_ref(fn):
    """The reference function ``fn`` jitted with its ``cfg`` static (eager
    JAX compiles op by op, which is slow)."""
    return jax.jit(fn, static_argnames="cfg")


def tol_of(f32: bool) -> float:
    return F32_TOL if f32 else BF16_TOL


def tdt(dtype: str):
    return common.dtype_of(dtype)


def jdt(dtype: str):
    return ref_common.dtype_of(dtype)


# ---------------------------------------------------------------------------
# chunked linear attention
# ---------------------------------------------------------------------------
def _la_inputs(rng, B, S, H, dk, dv):
    q, k = (rng.standard_normal((B, S, H, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    log_f = (-np.abs(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32)
    ig = rng.random((B, S, H)).astype(np.float32)
    return q, k, v, log_f, ig


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_linear_attention_with_initial_state(dtype):
    rng = np.random.default_rng(0)
    B, S, H, dk, dv, C = 2, 48, 3, 8, 12, 16
    q, k, v, log_f, ig = _la_inputs(rng, B, S, H, dk, dv)
    s0 = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    tol = F32_TOL if dtype == "float32" else BF16_TOL / 4
    # q, k, v in the dtype, the gates f32 (as the SSM and mLSTM pass them)
    jy, js = ref_la.chunked_linear_attention(
        *(jnp.asarray(a, jdt(dtype)) for a in (q, k, v)), jnp.asarray(log_f),
        jnp.asarray(ig), chunk=C, initial_state=jnp.asarray(s0))
    ty, ts = linear_attn.chunked_linear_attention(
        *(torch.from_numpy(a).to(tdt(dtype)) for a in (q, k, v)),
        torch.from_numpy(log_f), torch.from_numpy(ig), chunk=C,
        initial_state=torch.from_numpy(s0))
    assert ty.dtype == tdt(dtype) and ts.dtype == torch.float32
    assert_close(ty, jy, tol, "y")
    assert_close(ts, js, tol, "state")
    # no initial state: a zero f32 state
    jy0, js0 = ref_la.chunked_linear_attention(
        *(jnp.asarray(a) for a in (q, k, v, log_f, ig)), chunk=C)
    ty0, ts0 = linear_attn.chunked_linear_attention(
        *(torch.from_numpy(a) for a in (q, k, v, log_f, ig)), chunk=C)
    assert_close(ty0, jy0, F32_TOL, "y, zero state")
    assert_close(ts0, js0, F32_TOL, "state, zero state")
    with pytest.raises(AssertionError):
        linear_attn.chunked_linear_attention(
            *(torch.from_numpy(a) for a in (q, k, v, log_f, ig)), chunk=20)


def test_chunked_linear_attention_matches_recurrence():
    """Chunkwise SSD == the step-by-step recurrence (the reference's
    ``test_chunked_linear_attention_matches_recurrence`` on the port), and
    the port's step == the reference's step."""
    rng = np.random.default_rng(2)
    B, S, H, dk, dv, C = 2, 64, 3, 8, 12, 16
    q, k, v, log_f, ig = (torch.from_numpy(a) for a in
                          _la_inputs(rng, B, S, H, dk, dv))
    y_chunk, state_chunk = linear_attn.chunked_linear_attention(
        q, k, v, log_f, ig, chunk=C)
    state = torch.zeros((B, H, dk, dv))
    jstate = jnp.zeros((B, H, dk, dv), jnp.float32)
    ys = []
    for t in range(S):
        yt, state = linear_attn.linear_attention_step(
            state, q[:, t], k[:, t], v[:, t], log_f[:, t], ig[:, t])
        jyt, jstate = ref_la.linear_attention_step(
            jstate, *(jnp.asarray(a[:, t].numpy())
                      for a in (q, k, v, log_f, ig)))
        assert_close(yt, jyt, F32_TOL, f"step {t}")
        ys.append(yt)
    assert_close(state, jstate, F32_TOL, "stepped state")
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(state_chunk.numpy(), state.numpy(),
                               rtol=1e-3, atol=1e-3)


def test_linear_attention_step_bf16():
    rng = np.random.default_rng(3)
    B, H, dk, dv = 3, 2, 8, 16
    s = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    q, k = (rng.standard_normal((B, H, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, dv)).astype(np.float32)
    lf = (-rng.random((B, H))).astype(np.float32)
    ig = rng.random((B, H)).astype(np.float32)
    jy, js = ref_la.linear_attention_step(
        jnp.asarray(s), *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(lf), jnp.asarray(ig))
    ty, ts = linear_attn.linear_attention_step(
        torch.from_numpy(s),
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        torch.from_numpy(lf), torch.from_numpy(ig))
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    assert_close(ty, jy, BF16_TOL / 4, "y")
    assert_close(ts, js, F32_TOL, "state")


# ---------------------------------------------------------------------------
# Mamba-2 and the hybrid layout
# ---------------------------------------------------------------------------
def _layer_params(arch, f32, pick):
    """Layer 0 of a stack of the smoke model's parameters in both
    packages: ``pick(params)`` selects the stack."""
    rm, rp, tm, tp = pair(arch, f32)
    jp = jax.tree.map(lambda a: a[0], pick(rp))
    return rm.cfg, jp, common.tree_map(lambda a: a[0], pick(tp))


def _seeded(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a, jdt(dtype)), torch.from_numpy(a).to(tdt(dtype))


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_mamba_forward_and_step(f32):
    cfg, jp, tp = _layer_params("zamba2_1_2b", f32, lambda p: p["mamba"])
    dt = "float32" if f32 else "bfloat16"
    tol = F32_TOL if f32 else BF16_TOL / 2
    rng = np.random.default_rng(4)
    jx, tx = _seeded(rng, (2, 2 * cfg.ssm.chunk, cfg.d_model), dt)
    assert_close(ssm.mamba_forward(tp, tx, cfg),
                 jit_ref(ref_ssm.mamba_forward)(jp, jx, cfg=cfg), tol,
                 "forward")
    di, H, ds, K = ssm._mamba_dims(cfg)
    assert (di, H, ds, K) == ref_ssm._mamba_dims(cfg)
    js, ts = _seeded(rng, (2, H, ds, cfg.ssm.head_dim), "float32")
    jc, tc = _seeded(rng, (2, K - 1, di + 2 * ds), dt)
    jx1, tx1 = _seeded(rng, (2, 1, cfg.d_model), dt)
    jy, jst = jit_ref(ref_ssm.mamba_step)(jp, jx1, {"ssm": js, "conv": jc},
                                          cfg=cfg)
    ty, tst = ssm.mamba_step(tp, tx1, {"ssm": ts, "conv": tc}, cfg)
    assert_close(ty, jy, tol, "step")
    assert_tree_close(tst, jst, tol, "step state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_depthwise_conv_tap_by_tap(dtype):
    rng = np.random.default_rng(5)
    jx, tx = _seeded(rng, (2, 9, 24), dtype)
    jw, tw = _seeded(rng, (4, 24), dtype)
    got = ssm._causal_depthwise_conv(tx, tw)
    want = ref_ssm._causal_depthwise_conv(jx, jw)
    assert got.dtype == tdt(dtype)
    # each product and sum rounds in the dtype, in the same order: bf16
    # results are the reference's bit for bit
    np.testing.assert_array_equal(as_np(got), as_np(want))


@pytest.mark.parametrize("n_layers,every", [(5, 2), (38, 6), (8, 6), (4, 0)])
def test_hybrid_layout(n_layers, every):
    cfg = configs.get_smoke_config("zamba2_1_2b")
    cfg = dataclasses.replace(cfg, n_layers=n_layers, ssm=dataclasses.replace(
        cfg.ssm, shared_attn_every=every))
    rcfg = ref_configs.get_smoke_config("zamba2_1_2b")
    rcfg = dataclasses.replace(rcfg, n_layers=n_layers,
                               ssm=dataclasses.replace(
                                   rcfg.ssm, shared_attn_every=every))
    assert ssm.hybrid_layout(cfg) == ref_ssm.hybrid_layout(rcfg)
    if (n_layers, every) == (38, 6):       # zamba2-1.2b: 6 groups of 6 + 2
        assert ssm.hybrid_layout(cfg) == (6, 6, 2)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_mlstm_forward_and_step(f32):
    cfg, jp, tp = _layer_params("xlstm_125m", f32, lambda p: p["mlstm"])
    dt = "float32" if f32 else "bfloat16"
    tol = F32_TOL if f32 else BF16_TOL / 2
    rng = np.random.default_rng(6)
    jx, tx = _seeded(rng, (2, 2 * cfg.xlstm.chunk, cfg.d_model), dt)
    assert_close(xlstm.mlstm_forward(tp, tx, cfg),
                 jit_ref(ref_xlstm.mlstm_forward)(jp, jx, cfg=cfg), tol,
                 "forward")
    di, H, hd = xlstm._mlstm_dims(cfg)
    js, ts = _seeded(rng, (2, H, hd, 2 * hd), "float32")
    jx1, tx1 = _seeded(rng, (2, 1, cfg.d_model), dt)
    jy, jst = jit_ref(ref_xlstm.mlstm_step)(jp, jx1, js, cfg=cfg)
    ty, tst = xlstm.mlstm_step(tp, tx1, ts, cfg)
    assert_close(ty, jy, tol, "step")
    assert tst.dtype == torch.float32
    assert_close(tst, jst, tol, "step state")


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_slstm_forward_and_step(f32):
    cfg, jp, tp = _layer_params("xlstm_125m", f32, lambda p: p["slstm"])
    dt = "float32" if f32 else "bfloat16"
    tol = F32_TOL if f32 else BF16_TOL / 2
    rng = np.random.default_rng(7)
    jx, tx = _seeded(rng, (2, 12, cfg.d_model), dt)
    assert_close(xlstm.slstm_forward(tp, tx, cfg),
                 jit_ref(ref_xlstm.slstm_forward)(jp, jx, cfg=cfg), tol,
                 "forward")
    d = cfg.d_model
    jh, th = _seeded(rng, (2, d), dt)
    jc, tc = _seeded(rng, (2, d), "float32")
    jn, tn = _seeded(rng, (2, d), "float32")
    tn, jn = tn.abs(), jnp.abs(jn)
    jx1, tx1 = _seeded(rng, (2, 1, d), dt)
    jy, jst = jit_ref(ref_xlstm.slstm_step)(jp, jx1, (jh, jc, jn), cfg=cfg)
    ty, tst = xlstm.slstm_step(tp, tx1, (th, tc, tn), cfg)
    assert_close(ty, jy, tol, "step")
    assert [a.dtype for a in tst] == [tdt(dt), torch.float32, torch.float32]
    for name, g, w in zip("hcn", tst, jst):
        assert_close(g, w, tol, f"state {name}")


def test_xlstm_layout_asserts_the_pattern():
    cfg = configs.get_smoke_config("xlstm_125m")
    assert xlstm.xlstm_layout(cfg) == ref_xlstm.xlstm_layout(
        ref_configs.get_smoke_config("xlstm_125m")) == (1, 3)
    assert xlstm.xlstm_layout(configs.get_config("xlstm_125m")) == (3, 3)
    with pytest.raises(AssertionError, match="block pattern"):
        xlstm.xlstm_layout(dataclasses.replace(cfg, n_layers=6))


# ---------------------------------------------------------------------------
# MLA and cross-attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_mla_forward_and_decode(f32):
    cfg, jp, tp = _layer_params("deepseek_v2_236b", f32,
                                lambda p: p["layers"]["attn"])
    m = cfg.mla
    dt = "float32" if f32 else "bfloat16"
    tol = F32_TOL if f32 else BF16_TOL / 2
    rng = np.random.default_rng(8)
    B, S = 3, 12
    jx, tx = _seeded(rng, (B, S, cfg.d_model), dt)
    jcs, jsn = ref_common.rope_angles(jnp.arange(S), m.rope_head_dim,
                                      cfg.rope_theta)
    tcs, tsn = common.rope_angles(torch.arange(S), m.rope_head_dim,
                                  cfg.rope_theta)
    assert_close(attention.mla_forward(tp, tx, cfg, tcs, tsn),
                 jit_ref(ref_attn.mla_forward)(jp, jx, cfg=cfg, cos=jcs,
                                               sin=jsn), tol, "forward")
    # decode at per-row positions over a seeded latent cache
    pos = np.array([0, 5, S - 1], np.int32)
    jcs, jsn = ref_common.rope_angles(jnp.asarray(pos)[:, None],
                                      m.rope_head_dim, cfg.rope_theta)
    tcs, tsn = common.rope_angles(torch.from_numpy(pos)[:, None],
                                  m.rope_head_dim, cfg.rope_theta)
    jc, tc = _seeded(rng, (B, S, m.kv_lora_rank), dt)
    jr, tr = _seeded(rng, (B, S, m.rope_head_dim), dt)
    jx1, tx1 = _seeded(rng, (B, 1, cfg.d_model), dt)
    jy, jrows = jit_ref(ref_attn.mla_decode)(
        jp, jx1, {"c": jc, "r": jr}, jnp.asarray(pos), cfg=cfg, cos=jcs,
        sin=jsn)
    ty, trows = attention.mla_decode(tp, tx1, {"c": tc, "r": tr},
                                     torch.from_numpy(pos), cfg, tcs, tsn)
    assert_close(ty, jy, tol, "decode")
    assert_tree_close(trows, jrows, tol, "rows")


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_cross_attention_and_encoder(f32):
    rm, rp, tm, tp = pair("whisper_tiny", f32)
    cfg = rm.cfg
    dt = "float32" if f32 else "bfloat16"
    tol = F32_TOL if f32 else BF16_TOL / 2
    rng = np.random.default_rng(9)
    jf, tf = _seeded(rng, (2, 16, cfg.d_model), dt)
    jenc = jax.jit(ref_api._encode, static_argnums=0)(cfg, rp, jf)
    tenc = api._encode(tm.cfg, tp, tf)
    assert_close(tenc, jenc, tol, "encode")
    jl = jax.tree.map(lambda a: a[0], rp["dec"]["cross"])
    tl = common.tree_map(lambda a: a[0], tp["dec"]["cross"])
    jkv = jit_ref(ref_attn.cross_kv)(jl, jenc, cfg=cfg)
    tkv = attention.cross_kv(tl, tenc, tm.cfg)
    assert_tree_close(tkv, jkv, tol, "cross_kv")
    jx, tx = _seeded(rng, (2, 5, cfg.d_model), dt)
    assert_close(attention.cross_forward(tl, tx, tkv, tm.cfg),
                 jit_ref(ref_attn.cross_forward)(jl, jx, jkv, cfg=cfg), tol,
                 "cross")
    # the positional term, at per-row positions
    p = np.array([0, 3, 1499], np.int32)
    assert_close(api._sinusoid(torch.from_numpy(p), cfg.d_model),
                 ref_api._sinusoid(jnp.asarray(p), cfg.d_model), F32_TOL,
                 "sinusoid")


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
def test_build_model_builds_every_config():
    """All ten configs build (the smoke configs' parameters drawn), with
    the reference's parameter tree: names, shapes, dtypes."""
    for arch in configs.ARCHS:
        tm = build_model(configs.get_smoke_config(arch), device="cpu")
        own = common.tree_map(lambda a: (tuple(a.shape), a.dtype),
                              tm.init(0))
        rm = ref_build(ref_configs.get_smoke_config(arch))
        shapes = jax.eval_shape(rm.init, jax.random.PRNGKey(0))
        want = jax.tree.map(lambda a: (tuple(a.shape), a.dtype.name), shapes)
        assert common.tree_map(lambda s: (s[0], str(s[1]).split(".")[-1]),
                               own) == want, arch
        cache = tm.init_cache(2, 16, torch.bfloat16)
        rc = jax.eval_shape(lambda: rm.init_cache(2, 16, jnp.bfloat16))
        assert common.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
            cache) == jax.tree.map(lambda a: (a.shape, a.dtype.name), rc), arch


def _seeded_cache(rng, rm, B, S, dtype):
    """A seeded cache of the reference's tree in both packages: f32 leaves
    stay f32, the others in ``dtype``."""
    zero = rm.init_cache(B, S, jdt(dtype))
    arrays = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.5, zero)
    jc = jax.tree.map(lambda a, z: jnp.asarray(a, z.dtype), arrays, zero)
    return jc, cache_from_arrays(arrays, tdt(dtype), device="cpu")


def _frames(rng, cfg, B, Se):
    return rng.standard_normal((B, Se, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_steps(arch, f32):
    """Several decode steps at per-row (staggered) positions from a seeded
    cache (whisper: its prefill's cross cache and a seeded self cache),
    logits and every cache leaf."""
    rm, rp, tm, tp = pair(arch, f32)
    cfg = tm.cfg
    dt = cfg.compute_dtype
    B, S = 3, 24
    rng = np.random.default_rng(10)
    jc, tc = _seeded_cache(rng, rm, B, S, dt)
    if cfg.family == "encdec":
        fr = _frames(rng, cfg, B, S)
        _, jpre = jax.jit(rm.prefill, static_argnames="cache_len")(
            rp, {"frames": jnp.asarray(fr)}, cache_len=S)
        _, tpre = tm.prefill(tp, {"frames": torch.from_numpy(fr)}, cache_len=S)
        jc["cross"], tc["cross"] = jpre["cross"], tpre["cross"]
    dec = jax.jit(rm.decode_step)
    pos = np.array([0, 4, 17], np.int32)
    tol = tol_of(f32)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
        jl, jc = dec(rp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        assert tl.dtype == tdt(dt)
        assert_close(tl, jl, tol, f"logits step {step}")
        if f32:
            assert np.array_equal(as_np(tl).argmax(-1), as_np(jl).argmax(-1))
        assert_tree_close(tc, jc, tol, f"cache step {step}")
        pos = pos + 1


def _batch(rng, cfg, B, S):
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.family == "encdec":
        batch["frames"] = _frames(rng, cfg, B, S)
    return batch


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_loss(arch, f32):
    """Prefill logits and every leaf of its cache (zero SSM / xLSTM
    states, a zero MLA cache, whisper's cross K/V), and the loss value;
    sequences a multiple of the recurrent archs' chunk."""
    rm, rp, tm, tp = pair(arch, f32)
    cfg = tm.cfg
    chunk = (cfg.ssm.chunk if cfg.ssm else cfg.xlstm.chunk if cfg.xlstm
             else 8)
    batch = _batch(np.random.default_rng(11), cfg, 2, 2 * chunk)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tol = tol_of(f32)
    kw = {"cache_len": 20} if cfg.family == "encdec" else {}
    jl, jc = jax.jit(rm.prefill, static_argnames=tuple(kw))(rp, jb, **kw)
    tl, tc = tm.prefill(tp, tb, **kw)
    assert_close(tl, jl, tol, "prefill logits")
    if f32:
        assert np.array_equal(as_np(tl).argmax(-1), as_np(jl).argmax(-1))
    assert_tree_close(tc, jc, tol, "prefill cache")
    if cfg.family != "encdec":      # the reference's zero caches
        assert all(not bool(a.any()) for a in common.tree_leaves(tc))
    want = float(jax.jit(rm.loss)(rp, jb))
    got = float(tm.loss(tp, tb))
    np.testing.assert_allclose(got, want, rtol=1e-5 if f32 else 2e-2)


@pytest.mark.parametrize("arch", ["zamba2_1_2b", "xlstm_125m"])
def test_recurrent_prefill_needs_whole_chunks(arch):
    _, _, tm, tp = pair(arch, True)
    toks = torch.zeros((1, 10), dtype=torch.int32)
    with pytest.raises(AssertionError):
        tm.prefill(tp, {"tokens": toks, "labels": toks})


def test_decode_continues_from_a_converted_cache():
    """A reference cache carried across by ``convert.cache_from_arrays``
    (f32 states stay f32) continues alike in the port."""
    rm, rp, tm, tp = pair("zamba2_1_2b", False)
    rng = np.random.default_rng(12)
    jc = rm.init_cache(2, 16, jnp.bfloat16)
    dec = jax.jit(rm.decode_step)
    pos = np.array([0, 3], np.int32)
    for _ in range(3):
        tok = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
        _, jc = dec(rp, jc, jnp.asarray(tok), jnp.asarray(pos))
        pos = pos + 1
    tc = cache_from_arrays(np_tree(jc), torch.bfloat16, device="cpu")
    assert tc["ssm"].dtype == torch.float32
    tok = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
    jl, jc2 = dec(rp, jc, jnp.asarray(tok), jnp.asarray(pos))
    tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok),
                             torch.from_numpy(pos))
    assert_close(tl, jl, BF16_TOL, "continued logits")
    assert_tree_close(tc2, jc2, BF16_TOL, "continued cache")
