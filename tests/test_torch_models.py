"""The port's decoder family (``repro_torch.models``) against ``repro.models``.

On the CPU, at the smoke configs.  Inputs are made by numpy from a seed and
handed to both packages; the JAX parameters (``model.init(PRNGKey(0))``)
cross into the port through ``convert.model_params_from_arrays`` (bf16
leaves upcast to f32 on the way, which is exact).  Tolerances:

* ``F32_TOL`` (2e-5 of the reference's largest magnitude): f32 products
  summed in another order and XLA's f32 ``pow`` / ``cos`` against the
  port's correctly rounded ones; argmax tokens must be equal;
* ``BF16_TOL`` (6e-2 of the largest magnitude): bf16 keeps 8 bits, every
  product, norm and residual rounds, and a value on a rounding boundary
  may round the other way in the other package; the error grows with the
  layers (2.6e-2 measured on granite-moe's smoke config over 8 steps);
* exact: config fields, parameter counts, int8 KV codes, MoE top-k sets
  and dropped assignments.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro.models.api import build_model as ref_build

from repro_torch import configs
from repro_torch.convert import cache_from_arrays, model_params_from_arrays
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import attention, common, mlp
from repro_torch.models.api import build_model
from repro_torch.models.shard_ctx import constrain, use_mesh

F32_TOL = 2e-5
BF16_TOL = 6e-2
DECODERS = ["qwen2_5_3b", "codeqwen1_5_7b", "h2o_danube_1_8b",
            "command_r_35b", "granite_moe_3b_a800m", "phi_3_vision_4_2b"]


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


def variant(cfg, f32: bool):
    if not f32:
        return cfg
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def pair(arch: str, f32: bool):
    """(reference model, its params, port model, its params) at the smoke
    config, the port's parameters converted from the reference's."""
    rcfg = variant(ref_configs.get_smoke_config(arch), f32)
    tcfg = variant(configs.get_smoke_config(arch), f32)
    rm = ref_build(rcfg)
    rp = rm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = model_params_from_arrays(tcfg, np_tree(rp), device="cpu")
    return rm, rp, tm, tp


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_registry_tables_equal():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.ALIASES == ref_configs.ALIASES
    assert configs.SHAPES == ref_configs.SHAPES
    for a in configs.ARCHS:
        assert configs.resolve(a.replace("_", "-")) == ref_configs.resolve(
            a.replace("_", "-"))


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_configs_field_for_field(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(ref_configs, get)(arch)
        got = getattr(configs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert type(got).__name__ == type(want).__name__
        for active in (False, True):
            assert got.param_count(active) == want.param_count(active)
        for decode in (False, True):
            assert got.flops_per_token(4096, decode) == \
                want.flops_per_token(4096, decode)
        assert (got.head_dim, got.subquadratic) == (want.head_dim,
                                                     want.subquadratic)
        for shape in configs.SHAPES:
            assert configs.shape_applicable(got, shape) == \
                ref_configs.shape_applicable(want, shape)
    if want.moe is not None:
        assert got.moe.n_experts_padded == want.moe.n_experts_padded


def test_shard_ctx_identity_without_mesh_and_raises_with_one():
    """The identity without a mesh and under one (a sharding constraint
    leaves values unchanged); under a mesh the spec is computed, and a
    mesh without axes refuses."""
    x = torch.ones(2, 3)
    assert constrain(x, ("dp", None)) is x
    with use_mesh(make_test_mesh(devices=["cpu"] * 8)):
        assert constrain(x, ("dp", None)) is x
    with use_mesh(object()), pytest.raises(AttributeError):
        constrain(x, ("dp", None))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jd, td = ref_common.dtype_of(dtype), common.dtype_of(dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL / 4
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    assert_close(common.rmsnorm(torch.from_numpy(scale).to(td), tx),
                 ref_common.rmsnorm(jnp.asarray(scale, jd), jx), tol, "rms")
    assert_close(
        common.layernorm({"scale": torch.from_numpy(scale).to(td),
                          "bias": torch.from_numpy(bias).to(td)}, tx),
        ref_common.layernorm({"scale": jnp.asarray(scale, jd),
                              "bias": jnp.asarray(bias, jd)}, jx), tol, "ln")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    pos = np.array([[0, 1, 7, 300], [5, 4096, 32767, 100000]], np.int32)
    jc, js = ref_common.rope_angles(jnp.asarray(pos), 16, 10000.0)
    tc, ts = common.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    assert tc.dtype == torch.float32
    # absolute: XLA's f32 cos / pow against correctly rounded ones, at
    # angles up to 1e5 rad (the product itself is the same f32 op)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6)
    x = np.random.default_rng(1).standard_normal((2, 4, 3, 16)).astype(np.float32)
    jd, td = ref_common.dtype_of(dtype), common.dtype_of(dtype)
    got = common.apply_rope(torch.from_numpy(x).to(td), tc, ts)
    want = ref_common.apply_rope(jnp.asarray(x, jd), jc, js)
    assert got.dtype == td
    assert_close(got, want, F32_TOL if dtype == "float32" else BF16_TOL / 4)


def _qkv(rng, B, Sq, Sk, H, D, dtype):
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for S in (Sq, Sk, Sk))
    return [(jnp.asarray(a, ref_common.dtype_of(dtype)),
             torch.from_numpy(a).to(common.dtype_of(dtype))) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 12), (False, 0)])
def test_attention_dense_and_chunked(dtype, causal, window):
    rng = np.random.default_rng(2)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 32, 32, 4, 16, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL / 4
    want = ref_attn.attention_dense(jq, jk, jv, causal=causal, window=window)
    assert_close(attention.attention_dense(tq, tk, tv, causal=causal,
                                           window=window), want, tol, "dense")
    wantc = ref_attn.attention_chunked(jq, jk, jv, causal=causal,
                                       window=window, chunk=8)
    gotc = attention.attention_chunked(tq, tk, tv, causal=causal,
                                       window=window, chunk=8)
    assert_close(gotc, wantc, tol, "chunked")
    assert attention._chunk_pairs(4, 4, causal, window, 8) == \
        ref_attn._chunk_pairs(4, 4, causal, window, 8)


def test_attention_core_chunks_above_attn_chunk():
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2_5_3b"),
                              attn_impl="chunked", attn_chunk=8)
    rcfg = dataclasses.replace(ref_configs.get_smoke_config("qwen2_5_3b"),
                               attn_impl="chunked", attn_chunk=8)
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 24, 24, 4, 16, "float32")
    assert_close(attention.attention_core(tq, tk, tv, cfg, causal=True),
                 ref_attn.attention_core(jq, jk, jv, rcfg, causal=True),
                 F32_TOL)


def test_int8_kv_codes_equal():
    x = np.random.default_rng(4).standard_normal((3, 50)).astype(np.float32) * 4
    x[0, :6] = [0.5 / 24, 1.5 / 24, 2.5 / 24, -0.5 / 24, 200.0, -200.0]
    got = attention.encode_kv(torch.from_numpy(x), torch.int8)
    want = ref_attn.encode_kv(jnp.asarray(x), jnp.int8)
    assert np.array_equal(got.numpy(), np.asarray(want))
    dec = attention.decode_kv(got)
    assert dec.dtype == torch.bfloat16
    assert np.array_equal(dec.float().numpy(),
                          as_np(ref_attn.decode_kv(want)))


@pytest.mark.parametrize("case", ["full", "swa_wrapped", "int8", "bf16"])
def test_decode_attend(case):
    rng = np.random.default_rng(5)
    B, S, KH, G, D = 3, 16, 2, 2, 8
    window = 16 if case == "swa_wrapped" else 0
    pos = np.array([0, 9, 40] if window else [0, 9, 15], np.int32)
    kc, vc = (rng.standard_normal((B, S, KH, D)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((B, KH * G, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, KH, D)).astype(np.float32)
              for _ in range(2))
    if case == "int8":
        jk, jv = (ref_attn.decode_kv(ref_attn.encode_kv(jnp.asarray(a),
                                                        jnp.int8))
                  for a in (kc, vc))
        tk, tv = (attention.decode_kv(attention.encode_kv(
            torch.from_numpy(a), torch.int8)) for a in (kc, vc))
    else:
        jdt = jnp.bfloat16 if case == "bf16" else jnp.float32
        jk, jv = jnp.asarray(kc, jdt), jnp.asarray(vc, jdt)
        tdt = torch.bfloat16 if case == "bf16" else torch.float32
        tk, tv = torch.from_numpy(kc).to(tdt), torch.from_numpy(vc).to(tdt)
    want = ref_attn.decode_attend(jnp.asarray(q), jk, jv, jnp.asarray(kn),
                                  jnp.asarray(vn), jnp.asarray(pos),
                                  window=window)
    got = attention.decode_attend(torch.from_numpy(q), tk, tv,
                                  torch.from_numpy(kn), torch.from_numpy(vn),
                                  torch.from_numpy(pos), window=window)
    assert got.dtype == torch.float32
    assert_close(got, want, F32_TOL if case != "bf16" else BF16_TOL / 4, case)
    # a scalar position broadcasts over the rows
    want1 = ref_attn.decode_attend(jnp.asarray(q), jk, jv, jnp.asarray(kn),
                                   jnp.asarray(vn), jnp.int32(7), window=window)
    got1 = attention.decode_attend(torch.from_numpy(q), tk, tv,
                                   torch.from_numpy(kn), torch.from_numpy(vn),
                                   torch.tensor(7, dtype=torch.int32),
                                   window=window)
    assert_close(got1, want1, F32_TOL if case != "bf16" else BF16_TOL / 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_forward(dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    w = {n: rng.standard_normal(s).astype(np.float32) / 6 for n, s in
         (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
    jd, td = ref_common.dtype_of(dtype), common.dtype_of(dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL / 4
    for act in ("silu", "gelu"):
        keep = w if act == "silu" else {k: v for k, v in w.items() if k != "wg"}
        got = mlp.mlp_forward({k: torch.from_numpy(v).to(td)
                               for k, v in keep.items()},
                              torch.from_numpy(x).to(td), act)
        want = ref_mlp.mlp_forward({k: jnp.asarray(v, jd)
                                    for k, v in keep.items()},
                                   jnp.asarray(x, jd), act)
        assert_close(got, want, tol, act)


@pytest.mark.parametrize("capacity", [8, 3])
def test_routed_local_drops_in_order(capacity):
    """Given top-k tables: the same capacity tables (dropped assignments in
    flattened (token, k) order) and the same f32 combine."""
    rng = np.random.default_rng(7)
    T, d, f, E, k = 12, 16, 8, 16, 2
    x = rng.standard_normal((T, d)).astype(np.float32)
    # skewed routing so capacity 3 drops assignments
    idx = np.stack([rng.choice(4, size=2, replace=False) if t % 2 else
                    rng.choice(E - 4, size=2, replace=False) + 4
                    for t in range(T)]).astype(np.int32)
    w = rng.random((T, k)).astype(np.float32)
    wi, wg = (rng.standard_normal((E, d, f)).astype(np.float32) for _ in "ab")
    wo = rng.standard_normal((E, f, d)).astype(np.float32)
    kw = dict(n_experts=E, n_shards=1, shard_id=0, capacity=capacity)
    want = ref_mlp._routed_local(*(jnp.asarray(a) for a in
                                   (x, idx, w, wi, wg, wo)), **kw)
    got = mlp._routed_local(*(torch.from_numpy(a) for a in
                              (x, idx.astype(np.int64), w, wi, wg, wo)), **kw)
    assert_close(got, want, F32_TOL)
    if capacity == 3:      # some token lost an expert: its row differs
        full = mlp._routed_local(*(torch.from_numpy(a) for a in (
            x, idx.astype(np.int64), w, wi, wg, wo)),
            **{**kw, "capacity": 8})
        assert not torch.equal(full, got)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_v2_236b"])
def test_moe_forward(arch):
    """Top-k sets equal, aux loss and output within F32_TOL (deepseek's
    smoke config adds the shared experts; its MoE layer alone is ported)."""
    cfg = variant(configs.get_smoke_config(arch), True)
    rcfg = variant(ref_configs.get_smoke_config(arch), True)
    rng = np.random.default_rng(8)
    d, mo = cfg.d_model, cfg.moe
    Ep = mo.n_experts_padded
    p = {"router": rng.standard_normal((d, mo.n_experts)).astype(np.float32)
         / 8,
         "wi": rng.standard_normal((Ep, d, mo.d_ff_expert)).astype(np.float32)
         / 8,
         "wg": rng.standard_normal((Ep, d, mo.d_ff_expert)).astype(np.float32)
         / 8,
         "wo": rng.standard_normal((Ep, mo.d_ff_expert, d)).astype(np.float32)
         / 8}
    if mo.n_shared:
        sf = mo.n_shared * mo.d_ff_expert
        p["shared"] = {"wi": rng.standard_normal((d, sf)).astype(np.float32) / 8,
                       "wg": rng.standard_normal((d, sf)).astype(np.float32) / 8,
                       "wo": rng.standard_normal((sf, d)).astype(np.float32) / 8}
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = model_params_from_arrays(cfg, p, device="cpu")
    want, waux = ref_mlp.moe_forward(jp, jnp.asarray(x), rcfg)
    got, gaux = mlp.moe_forward(tp, torch.from_numpy(x), cfg)
    assert_close(got, want, F32_TOL, "moe")
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)
    _, _, t_idx = mlp.route(tp, torch.from_numpy(x).reshape(-1, d), cfg)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, d)) @ jp["router"], -1)
    _, j_idx = jax.lax.top_k(probs, mo.top_k)
    assert np.array_equal(t_idx.numpy(), np.asarray(j_idx))
    # a mesh whose model axis is 1 takes the reference's unsharded branch
    one = make_test_mesh(devices=["cpu"])
    assert torch.equal(mlp.moe_forward(tp, torch.from_numpy(x), cfg,
                                       mesh=one)[0], got)


def test_topk_ties_take_the_lower_index_first():
    cfg = variant(configs.get_smoke_config("granite_moe_3b_a800m"), True)
    E = cfg.moe.n_experts
    router = torch.zeros((4, E))
    router[0, [1, 5, 6]] = 1.0                 # three equal logits
    x = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    _, _, idx = mlp.route({"router": router}, x, cfg)
    probs = jax.nn.softmax(jnp.asarray(x.numpy()) @ jnp.asarray(router.numpy()))
    assert np.array_equal(idx.numpy(), np.asarray(jax.lax.top_k(probs, 2)[1]))
    assert idx.tolist() == [[1, 5]]


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
def _tokens(rng, cfg, B, S):
    return rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", DECODERS)
def test_decode_steps(arch, f32):
    """Several decode steps at per-row (staggered) positions, the cache in
    the compute dtype (f32 variant) or int8 where the config says so."""
    rm, rp, tm, tp = pair(arch, f32)
    cfg = tm.cfg
    B, S = 3, 24
    kv = "int8" if cfg.kv_cache_dtype == "int8" else cfg.compute_dtype
    jc = rm.init_cache(B, S, ref_common.dtype_of(kv))
    tc = tm.init_cache(B, S, common.dtype_of(kv))
    rng = np.random.default_rng(9)
    pos = np.array([0, 4, 17], np.int32)     # row 2 wraps h2o's window
    tol = F32_TOL if f32 else BF16_TOL
    for step in range(6):
        tok = _tokens(rng, cfg, B, 1)
        jl, jc = rm.decode_step(rp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        assert tl.dtype == common.dtype_of(cfg.compute_dtype)
        assert_close(tl, jl, tol, f"logits step {step}")
        if f32:
            assert np.array_equal(tl.float().numpy().argmax(-1),
                                  as_np(jl).argmax(-1))
        for name in ("k", "v"):
            want = np.asarray(jc["layers"][name].astype(jnp.float32))
            got = tc["layers"][name].float().numpy()
            if kv == "int8":      # codes one unit apart at most, rarely
                assert np.abs(got - want).max() <= 1
                assert np.mean(got != want) <= (1e-3 if f32 else 0.05)
            else:
                assert_close(got, want, tol, f"cache {name}")
        pos = pos + 1
    # a cache carried across the packages continues alike
    tc2 = cache_from_arrays(np_tree(jc), common.dtype_of(kv), device="cpu")
    tok = _tokens(rng, cfg, B, 1)
    jl, _ = rm.decode_step(rp, jc, jnp.asarray(tok), jnp.asarray(pos))
    tl, _ = tm.decode_step(tp, tc2, torch.from_numpy(tok), torch.from_numpy(pos))
    assert_close(tl, jl, tol, "continued from a converted cache")


def _batch(rng, cfg, B, S):
    toks = _tokens(rng, cfg, B, S)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.vlm is not None:
        batch["patches"] = rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.d_patch)).astype(np.float32)
    return batch


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_loss(arch, f32):
    rm, rp, tm, tp = pair(arch, f32)
    cfg = tm.cfg
    batch = _batch(np.random.default_rng(10), cfg, 2, 12)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tol = F32_TOL if f32 else BF16_TOL
    jl, jc = rm.prefill(rp, jb)
    tl, tc = tm.prefill(tp, tb)
    assert_close(tl, jl, tol, "prefill logits")
    if f32:
        assert np.array_equal(as_np(tl).argmax(-1), as_np(jl).argmax(-1))
    # the reference's prefill returns a zero cache of the prefill length
    assert jax.tree.map(lambda a: a.shape, jc) == \
        common.tree_map(lambda a: tuple(a.shape), tc)
    assert all(not bool(a.any()) for a in common.tree_leaves(tc))
    want = float(rm.loss(rp, jb))
    got = float(tm.loss(tp, tb))
    np.testing.assert_allclose(got, want, rtol=1e-5 if f32 else 2e-2)


def test_converted_params_keep_names_and_dtypes():
    rm, rp, tm, tp = pair("granite_moe_3b_a800m", False)
    flat_r = jax.tree_util.tree_flatten_with_path(rp)[0]
    for path, leaf in flat_r:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        want = torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16
        assert node.dtype == want, path
    assert common.count_params(tp) == sum(x.size for x in jax.tree.leaves(rp))
    # the port's own init draws the same shapes and dtypes
    own = tm.init(0)
    assert common.tree_map(lambda a: (tuple(a.shape), a.dtype), own) == \
        common.tree_map(lambda a: (tuple(a.shape), a.dtype), tp)
