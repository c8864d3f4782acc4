"""The port's training path against ``repro``'s, on the CPU.

Gradients (``models.api.value_and_grad`` against ``jax.value_and_grad``
of the reference's ``loss``), the optimisers (``optim/compress.py``,
``optim/adamw8bit.py``), ``launch/train.py`` (``choose_accum``,
``make_train_step``) and a reference training run resumed in the port
through ``convert.opt_state_from_arrays``.  Inputs are made by numpy from
a seed and handed to both packages; models take the reference's
parameters through ``convert.model_params_from_arrays``.  Tolerances:

* ``F32_TOL`` (2e-5 of each leaf's largest magnitude, as
  ``tests/test_torch_models.py``) for the loss and every gradient leaf of
  the f32 smoke configs: f32 sums in other orders and XLA's f32
  transcendentals against torch's;
* bitwise: remat on against remat off (the same ops recomputed), and the
  optimisers against the reference run EAGERLY.  Under ``jax.jit`` XLA
  contracts ``a * b - c`` into one fused multiply-add and divides by a
  constant as a multiply by its reciprocal, so a jitted update rounds
  differently from any op-by-op one (the card's and the port's); run op
  by op it gives the port's bits.  The updates run with the clip scale
  off (``clip_norm`` 1e9): the global norm is a sum of squares whose
  order differs between the packages, one f32 ulp at some steps, and the
  clip scale would carry that ulp into every parameter;
* the train step against the reference's jitted one over two steps at an
  f32 config: loss and grad norm within ``STEP_RTOL`` (1e-6), parameters
  within ``STEP_ATOL`` = 5% of the learning rate.  AdamW divides each
  gradient by its own running magnitude, so a gradient near zero whose
  last bits differ (summation order) moves its parameter by a visibly
  different share of the step; the 8-bit state rounds the moments to
  1/127 of their block's largest, and a moment on a rounding boundary
  lands one code away (at most 1 unit, in at most ``FLIP_SHARE`` of the
  codes): a parameter then moves by about 1/127 of its block's largest
  step.  The same holds for the compressed gradient's codes, so the error
  feedback (the residual ``g + e - q * scale``) is held bitwise against
  the reference's ``compress_gradients`` run eagerly on the port's own
  mean gradient and residual.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import train as ref_train
from repro.models.api import build_model as ref_build
from repro.models.config import ModelConfig as RefModelConfig
from repro.optim import adamw as ref_adamw
from repro.optim import adamw8bit as ref_8bit
from repro.optim import compress as ref_compress

from repro_torch import configs
from repro_torch.convert import model_params_from_arrays, opt_state_from_arrays
from repro_torch.launch import train
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model, value_and_grad
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, adamw8bit, compress

F32_TOL = 2e-5
STEP_RTOL = 1e-6
FLIP_SHARE = 0.01
ARCHS = ["qwen2_5_3b", "granite_moe_3b_a800m", "phi_3_vision_4_2b",
         "deepseek_v2_236b", "zamba2_1_2b", "xlstm_125m", "whisper_tiny"]
#: qwen2.5 at chunked attention with the sequence over its chunk, so the
#: rewritten ``attention_chunked`` and its backward run
CHUNKED = {"qwen2_5_3b": {"attn_impl": "chunked", "attn_chunk": 8}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread (tiny ops; see test_torch_models.py)."""
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


def port_leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def leaf_gap(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def smoke_pair(arch: str, f32: bool = True):
    """(reference model, params, port model, params) at the smoke config."""
    def variant(cfg):
        cfg = dataclasses.replace(cfg, **CHUNKED.get(arch, {}))
        if f32:
            cfg = dataclasses.replace(cfg, param_dtype="float32",
                                      compute_dtype="float32")
        return cfg

    rcfg = variant(ref_configs.get_smoke_config(arch))
    tcfg = variant(configs.get_smoke_config(arch))
    rm = ref_build(rcfg)
    rp = jax.jit(rm.init)(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    return rm, rp, tm, model_params_from_arrays(tcfg, np_tree(rp), "cpu")


def loss_batch(rng, cfg, B: int = 2):
    """Tokens, shifted labels and a 0/1 mask; patches or frames where the
    family takes them.  Recurrent families run two of their chunks, the
    rest 24 positions (three of qwen's 8-position attention chunks)."""
    rec = cfg.ssm or cfg.xlstm
    S = 2 * rec.chunk if rec else 24
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.vlm is not None:
        batch["patches"] = rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.d_patch)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_value_and_grad_equals_reference(arch):
    rm, rp, tm, tp = smoke_pair(arch)
    batch = loss_batch(np.random.default_rng(0), tm.cfg)
    jl, jg = jax.jit(jax.value_and_grad(rm.loss))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = value_and_grad(tm, tp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) <= F32_TOL * abs(float(jl))
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(tree_leaves(tg))
    for path, want in flat:
        got = port_leaf(tg, path)
        assert got.dtype == torch.float32 and got.shape == want.shape
        gap = leaf_gap(got, want)
        assert gap <= F32_TOL, (path, gap)
    # the value is model.loss's, which runs under no_grad
    assert float(tm.loss(tp, {k: torch.from_numpy(v)
                              for k, v in batch.items()})) == float(tl)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_and_grads_keep_dtypes(arch):
    """bf16 smoke configs: remat on == off bit for bit; each gradient in its
    parameter's dtype (bf16, the f32 router / SSM leaves f32)."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              **CHUNKED.get(arch, {}))
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    batch = {k: torch.from_numpy(v) for k, v in
             loss_batch(np.random.default_rng(1), cfg).items()}
    l1, g1 = value_and_grad(model, params, batch, remat=True)
    l0, g0 = value_and_grad(model, params, batch, remat=False)
    assert torch.equal(l1, l0)
    for p, a, b in zip(tree_leaves(params), tree_leaves(g1), tree_leaves(g0)):
        assert a.dtype == p.dtype and a.shape == p.shape
        assert torch.equal(a, b)
    assert any(bool(g.any()) for g in tree_leaves(g1))


def test_chunked_attention_forward_unchanged_under_grad():
    """The rewritten online softmax gives the same bits with grad on (its
    autograd path) as under no_grad, and a gradient reaches q, k and v."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 32, 4, 8)).astype(
        np.float32)) for _ in range(3))
    from repro_torch.models.attention import attention_chunked
    with torch.no_grad():
        want = attention_chunked(q, k, v, causal=True, window=0, chunk=8)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    got = attention_chunked(qs, ks, vs, causal=True, window=0, chunk=8)
    assert torch.equal(got.detach(), want)
    got.square().sum().backward()
    assert all(t.grad is not None and bool(t.grad.any()) for t in (qs, ks, vs))


# ---------------------------------------------------------------------------
# optimisers
# ---------------------------------------------------------------------------
def _grads(rng, shapes):
    return {name: rng.standard_normal(s).astype(np.float32)
            for name, s in shapes.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def assert_bitwise(got, want, what=""):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = port_leaf(got, path)
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, (what, path)
        assert np.array_equal(g.numpy(), w), (what, path)


def test_compress_gradients_bitwise():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 130), "b": (7,)}
    ef_r = ref_compress.ef_init(_jax(_grads(rng, shapes)))
    ef_t = compress.ef_init(_torch(_grads(rng, shapes)))
    assert_bitwise(ef_t, ef_r, "ef_init")
    for step in range(3):
        g = _grads(rng, shapes)
        g["b"] *= 1e-3
        q_r, ef_r = ref_compress.compress_gradients(_jax(g), ef_r)
        q_t, ef_t = compress.compress_gradients(_torch(g), ef_t)
        for name in shapes:
            (qr, sr), (qt, st) = q_r[name], q_t[name]
            assert qt.dtype == torch.int8
            assert np.array_equal(qt.numpy(), np.asarray(qr)), (step, name)
            assert st.item() == float(sr), (step, name)
        assert_bitwise(ef_t, ef_r, f"residual at step {step}")
        like = _jax(g)
        assert_bitwise(compress.decompress_gradients(q_t, _torch(g)),
                       ref_compress.decompress_gradients(q_r, like))


@pytest.mark.parametrize("shape", [(7,), (3, 130), (2, 5, 128), (4, 300)])
def test_quantise_blockwise_bitwise(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    q_r, s_r = ref_8bit.quantise(jnp.asarray(x))
    q_t, s_t = adamw8bit.quantise(torch.from_numpy(x))
    assert q_t.dtype == torch.int8 and tuple(q_t.shape) == shape
    assert np.array_equal(q_t.numpy(), np.asarray(q_r))
    assert np.array_equal(s_t.numpy(), np.asarray(s_r))
    back_r = ref_8bit.dequantise(q_r, s_r, shape)
    back_t = adamw8bit.dequantise(q_t, s_t, shape)
    assert np.array_equal(back_t.numpy(), np.asarray(back_r))
    assert np.abs(back_t.numpy() - x).max() <= np.abs(x).max() / 100.0


def test_adamw8bit_update_bitwise():
    """Four updates from the reference's state each time: the same codes,
    scales, parameters and step, with weight decay on the 2-D leaf."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1e9)
    rcfg, tcfg = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 300), "b": (300,)}
    p_r = _jax(_grads(rng, shapes))
    s_r = ref_8bit.adamw8bit_init(p_r)
    assert_bitwise(adamw8bit.adamw8bit_init(_torch(p_r)), s_r, "init")
    for step in range(4):
        g = _grads(rng, shapes)
        p_t, s_t = _torch(p_r), _torch(s_r)
        p_r, s_r, st_r = ref_8bit.adamw8bit_update(rcfg, _jax(g), s_r, p_r)
        p_t, s_t, st_t = adamw8bit.adamw8bit_update(tcfg, _torch(g), s_t,
                                                     p_t)
        assert_bitwise(p_t, p_r, f"params at step {step}")
        assert_bitwise(s_t, s_r, f"state at step {step}")
        assert st_t["lr"].item() == float(st_r["lr"])


def test_adamw8bit_tracks_exact_adamw():
    """``tests/test_optim8bit.py``'s convergence contract on the port."""
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, clip_norm=1e9,
                            warmup_steps=0, total_steps=10**9,
                            min_lr_frac=1.0)
    target = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 256)).astype(np.float32))
    p_exact = {"w": torch.zeros((4, 256))}
    p_q = {"w": torch.zeros((4, 256))}
    s_exact, s_q = adamw.adamw_init(p_exact), adamw8bit.adamw8bit_init(p_q)
    for _ in range(60):
        p_exact, s_exact, _ = adamw.adamw_update(
            cfg, {"w": 2.0 * (p_exact["w"] - target)}, s_exact, p_exact)
        p_q, s_q, _ = adamw8bit.adamw8bit_update(
            cfg, {"w": 2.0 * (p_q["w"] - target)}, s_q, p_q)
    loss_exact = float(torch.mean((p_exact["w"] - target) ** 2))
    loss_q = float(torch.mean((p_q["w"] - target) ** 2))
    assert loss_q < 2.0 * loss_exact + 1e-3
    assert loss_q < 0.05


def test_choose_accum_equals_reference():
    for arch in configs.ARCHS:
        for shape, spec in configs.SHAPES.items():
            for dp, model_size in ((1, 16), (16, 16), (64, 8)):
                args = (spec["seq_len"], spec["global_batch"], dp, model_size)
                assert train.choose_accum(configs.get_config(arch), *args) \
                    == ref_train.choose_accum(ref_configs.get_config(arch),
                                              *args), (arch, shape, dp)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
TINY = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=2,
            n_kv_heads=2, d_ff=64, vocab=128, tie_embeddings=True,
            param_dtype="float32", compute_dtype="float32")
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=50)
STEP_ATOL = 0.05 * OPT["lr"]
MODES = {"plain": (False, False), "compress": (True, False),
         "opt_8bit": (False, True), "compress_8bit": (True, True)}


def _opt_init(lib, params, compress_on: bool, opt_8bit: bool):
    init = lib[1] if opt_8bit else lib[0]
    state = init(params)
    if compress_on:
        state = {**state, "ef": lib[2](params)}
    return state


REF_INITS = (ref_adamw.adamw_init, ref_8bit.adamw8bit_init,
             ref_compress.ef_init)


def _batches(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, TINY["vocab"], (2, 2, 17)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def _ref_steps(mode: str, n_steps: int):
    """The reference's jitted train step from its init: [(params, opt,
    stats)] after each step."""
    compress_on, opt_8bit = MODES[mode]
    rm = ref_build(RefModelConfig(**TINY))
    step = jax.jit(ref_train.make_train_step(
        rm, ref_adamw.AdamWConfig(**OPT), compress=compress_on,
        opt_8bit=opt_8bit))
    p = rm.init(jax.random.PRNGKey(0))
    o = _opt_init(REF_INITS, p, compress_on, opt_8bit)
    out = [(p, o, None)]
    for b in _batches(n_steps):
        p, o, stats = step(p, o, _jax(b))
        out.append((p, o, stats))
    return out


def _port_step(mode: str, params_np, opt_np):
    compress_on, opt_8bit = MODES[mode]
    model = build_model(ModelConfig(**TINY), device="cpu")
    step = train.make_train_step(model, adamw.AdamWConfig(**OPT),
                                 compress=compress_on, opt_8bit=opt_8bit)
    return (step, model_params_from_arrays(model.cfg, params_np, "cpu"),
            opt_state_from_arrays(opt_np, "cpu"))


def assert_step_close(p_t, o_t, s_t, p_r, o_r, s_r, what):
    for key in ("loss", "grad_norm"):
        want = float(s_r[key])
        assert abs(float(s_t[key]) - want) <= STEP_RTOL * abs(want), (what,
                                                                      key)
    assert float(s_t["lr"]) == float(s_r["lr"])
    for path, want in jax.tree_util.tree_flatten_with_path(p_r)[0]:
        gap = np.abs(port_leaf(p_t, path).numpy() - np.asarray(want)).max()
        assert gap <= STEP_ATOL, (what, path, gap)
    assert int(o_t["step"]) == int(o_r["step"])
    if "mv" in o_r:
        for path, want in jax.tree_util.tree_flatten_with_path(o_r["mv"])[0]:
            if path[-1].key in ("m_q", "v_q"):
                got = port_leaf(o_t["mv"], path).numpy().astype(np.int32)
                d = np.abs(got - np.asarray(want, np.int32))
                assert d.max() <= 1 and d.mean() <= FLIP_SHARE, (what, path)


def _ef_from_reference(params, ef, batch):
    """The reference's ``compress_gradients``, run eagerly, on the port's
    mean gradient of ``batch`` at ``params`` and the port's residual
    ``ef``: the residual the port's compressed step must leave."""
    model = build_model(ModelConfig(**TINY), device="cpu")
    _, g = train.accumulate_gradients(
        model, jax.tree.map(torch.clone, params), batch)
    return ref_compress.compress_gradients(_jax(np_torch(g)),
                                           _jax(np_torch(ef)))[1]


def np_torch(tree):
    return jax.tree.map(lambda a: a.numpy().copy(), tree)


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_equals_reference(mode):
    ref = _ref_steps(mode, 2)
    step, p, o = _port_step(mode, np_tree(ref[0][0]), np_tree(ref[0][1]))
    for i, batch in enumerate(_batches(2)):
        if MODES[mode][0]:
            want_ef = _ef_from_reference(p, o["ef"], batch)
        p, o, stats = step(p, o, batch)
        assert_step_close(p, o, stats, *ref[i + 1], f"{mode} step {i}")
        if MODES[mode][0]:
            assert_bitwise(o["ef"], want_ef, f"{mode} residual at step {i}")


def test_train_step_donates_its_arguments():
    """The step writes the new state into the tensors passed in."""
    model = build_model(ModelConfig(**TINY), device="cpu")
    params = model.init(0)
    opt = adamw.adamw_init(params)
    before = {id(t) for t in tree_leaves(params) + tree_leaves(opt)}
    p2, o2, _ = train.make_train_step(model, adamw.AdamWConfig(**OPT))(
        params, opt, _batches(1)[0])
    assert {id(t) for t in tree_leaves(p2) + tree_leaves(o2)} == before
    assert int(opt["step"]) == 1


def test_reference_run_resumes_in_the_port():
    """Two reference steps (8-bit AdamW + compression), the state carried
    across as numpy, then a third step in each package."""
    ref = _ref_steps("compress_8bit", 3)
    p_r, o_r, _ = ref[2]
    step, p, o = _port_step("compress_8bit", np_tree(p_r), np_tree(o_r))
    assert o["mv"]["embed"]["m_q"].dtype == torch.int8
    assert o["step"].dtype == torch.int32 and int(o["step"]) == 2
    p, o, stats = step(p, o, _batches(3)[2])
    assert_step_close(p, o, stats, *ref[3], "resumed step")


def test_eval_step_and_mesh_refused():
    model = build_model(ModelConfig(**TINY), device="cpu")
    params = model.init(0)
    b = {k: v[0] for k, v in _batches(1)[0].items()}
    assert float(train.make_eval_step(model)(params, b)) == float(
        model.loss(params, {k: torch.from_numpy(v) for k, v in b.items()}))
    # a dense model's step under a mesh: the same values (the hints are
    # placement statements)
    mesh = make_test_mesh(devices=["cpu"] * 8)
    assert float(train.make_eval_step(model, mesh=mesh)(params, b)) == float(
        train.make_eval_step(model)(params, b))
    batch = _batches(1)[0]
    runs = [train.make_train_step(model, adamw.AdamWConfig(), mesh=m)(
        tree_map(lambda a: a.clone(), params), adamw.adamw_init(params),
        batch) for m in (None, mesh)]
    for a, c in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a, c)
