"""Model API over every architecture family (port of ``repro.models.api``).

``build_model(cfg, device=None)`` returns a :class:`Model` with:

* ``init(seed_or_generator) -> params``  (stacked-per-layer nested dict)
* ``loss(params, batch, mesh=None) -> scalar``  (next-token CE + MoE aux;
  the value, under ``no_grad``)
* ``prefill(params, batch, mesh=None) -> (logits_last, cache)``
* ``decode_step(params, cache, tokens, pos, mesh=None) -> (logits, cache)``
* ``init_cache(batch, cache_len, dtype) -> cache``  (zeros)

and :func:`value_and_grad` ``(model, params, batch) -> (loss, grads)``,
``jax.value_and_grad(model.loss)``, with every layer rematerialised in the
backward (``torch.utils.checkpoint`` where the reference has
``jax.checkpoint``).

Families: decoder-only transformers (dense GQA, MoE, VLM and DeepSeek-V2's
MLA, whose cache holds the compressed latent ``c`` / ``r``), the
encoder-decoder (Whisper's backbone; the cache holds the decoder's
``self`` and ``cross`` K/V), the SSM / Zamba2 hybrid (f32 ``ssm`` state,
``conv`` window, the shared block's ``attn`` K/V) and xLSTM (f32
``mlstm`` state, ``slstm_h`` / ``slstm_c`` / ``slstm_n``).  Layers loop in
Python over the stacked ``(L, ...)`` parameters, eagerly (the reference's
``lax.scan``).  Everything runs on CUDA unless the caller passes
``device="cpu"``.

Reference behaviours the port copies: the SSM and xLSTM prefills return
ZERO caches (the prompt's recurrent state is not carried into decode),
and the encoder-decoder's ``init_cache`` sizes the cross cache at the
self cache's length.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Callable

import torch
import torch.utils.checkpoint

from ..core.replay import resolve_device
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .attention import (
    cross_forward,
    cross_kv,
    gqa_decode,
    gqa_forward,
    init_cross,
    init_gqa,
    init_mla,
    mla_decode,
    mla_forward,
)
from .common import (
    apply_norm,
    cross_entropy,
    dense_init,
    dtype_of,
    embed_init,
    f32_accumulation,
    make_norm,
    MetaGenerator,
    mm,
    rmsnorm,
    rope_angles,
    tree_leaves,
    tree_map,
)
from .config import ModelConfig
from .mlp import init_mlp, init_moe, mlp_forward, moe_forward
from .shard_ctx import constrain, constrain_cache, use_mesh

Params = Any

@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    device: torch.device = torch.device("cuda")
    #: the loss without ``loss``'s ``no_grad`` context (:func:`value_and_grad`)
    loss_fn: Callable | None = None


def _generator(seed_or_gen, device: torch.device) -> torch.Generator:
    if device.type == "meta":
        return MetaGenerator()
    if isinstance(seed_or_gen, torch.Generator):
        if seed_or_gen.device.type != device.type:
            raise ValueError(f"a {seed_or_gen.device} generator cannot draw "
                             f"parameters on {device}")
        return seed_or_gen
    return torch.Generator(device=device).manual_seed(int(seed_or_gen))


def _layer(stack, i: int):
    """Layer ``i``'s parameters (or cache) of a stacked ``(L, ...)`` tree."""
    return tree_map(lambda a: a[i], stack)


def _n_layers(stack) -> int:
    while isinstance(stack, dict):
        stack = next(iter(stack.values()))
    return stack.shape[0]


def _layers(stack) -> list:
    """Every layer's parameters of a stacked ``(L, ...)`` tree, as views
    from one ``unbind`` a leaf: the backward stacks the layers' gradients
    once (indexing ``a[i]`` would add L full-size zero-padded gradients)."""
    per_leaf = tree_map(lambda a: a.unbind(0), stack)
    return [tree_map(lambda t: t[i], per_leaf)
            for i in range(_n_layers(stack))]


_TLS = threading.local()


@contextlib.contextmanager
def _remat_layers(on: bool):
    prev = getattr(_TLS, "remat", False)
    _TLS.remat = on
    try:
        yield
    finally:
        _TLS.remat = prev


def _remat(fn, *args):
    """``fn(*args)``; under :func:`value_and_grad` (grad on, remat asked
    for) its activations are recomputed in the backward from ``args``
    instead of kept, as the reference's ``jax.checkpoint`` of a layer."""
    if torch.is_grad_enabled() and getattr(_TLS, "remat", False):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _sinusoid(pos, d):
    """Whisper's positional term of int ``pos`` (...,): (..., d) f32.
    ``pow``, ``sin`` and ``cos`` are taken in f64 and rounded once (as
    ``rope_angles``), the angle's product is the reference's f32 step."""
    half = d // 2
    e = torch.arange(half, dtype=torch.float32, device=pos.device) / half
    freqs = 1.0 / torch.pow(10000.0, e.double()).float()
    ang = (pos.float()[..., None] * freqs).double()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


def _rope_dim(cfg: ModelConfig) -> int:
    return cfg.mla.rope_head_dim if cfg.mla else cfg.head_dim


# ===========================================================================
# decoder-only transformers (dense / MoE / VLM / MLA)
# ===========================================================================
def _init_decoder(cfg: ModelConfig, device: torch.device, seed_or_gen) -> Params:
    gen = _generator(seed_or_gen, device)
    dt = dtype_of(cfg.param_dtype)
    d, V = cfg.d_model, cfg.vocab
    first_k = cfg.moe.first_k_dense if cfg.moe else 0
    L_moe = cfg.n_layers - first_k
    p: dict = {
        "embed": embed_init(gen, (V, d), dt),
        "final_norm": make_norm(cfg.norm, d, dt, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (d, V), dt, fan_in=d)
    if cfg.vlm is not None:
        p["patch_proj"] = dense_init(gen, (cfg.vlm.d_patch, d), dt,
                                     fan_in=cfg.vlm.d_patch)

    def norms(L):
        if cfg.norm == "rmsnorm":
            return torch.ones((L, d), dtype=dt, device=device)
        return {"scale": torch.ones((L, d), dtype=dt, device=device),
                "bias": torch.zeros((L, d), dtype=dt, device=device)}

    def layer_stack(L, moe: bool):
        return {
            "attn": (init_mla if cfg.mla else init_gqa)(gen, cfg, L, dt),
            "mlp": init_moe(gen, cfg, L, dt) if moe else init_mlp(
                gen, d, (cfg.moe.d_ff_dense or cfg.d_ff) if cfg.moe else cfg.d_ff,
                L, dt, cfg.activation
            ),
            "norm1": norms(L),
            "norm2": norms(L),
        }

    if first_k > 0:
        p["dense_prefix"] = layer_stack(first_k, moe=False)
    p["layers"] = layer_stack(L_moe, moe=cfg.moe is not None)
    return p


def _decoder_block(cfg: ModelConfig, lp, x, aux, cos, sin, *, mesh, moe: bool):
    """One pre-norm block: (x, aux) -> (x, aux)."""
    h = apply_norm(cfg.norm, lp["norm1"], x)
    a = (mla_forward if cfg.mla else gqa_forward)(lp["attn"], h, cfg, cos, sin)
    x = constrain(x + a, ("dp", None, None))
    h = apply_norm(cfg.norm, lp["norm2"], x)
    if moe:
        y, al = moe_forward(lp["mlp"], h, cfg, mesh=mesh)
        return constrain(x + y, ("dp", None, None)), aux + al
    return constrain(x + mlp_forward(lp["mlp"], h, cfg.activation),
                     ("dp", None, None)), aux


def _decoder_hidden(cfg: ModelConfig, p, batch, mesh):
    """Embed inputs and run the layer stack; returns (hidden, aux_loss)."""
    tokens = batch["tokens"]
    x = p["embed"][tokens.long()]
    if cfg.vlm is not None:
        patches = mm(batch["patches"].to(x.dtype), p["patch_proj"])
        x = torch.cat([patches, x], dim=1)
    S = x.shape[1]
    cos, sin = rope_angles(torch.arange(S, device=x.device), _rope_dim(cfg),
                           cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stacks = (("dense_prefix", False), ("layers", cfg.moe is not None))
    for name, moe in stacks:
        if name not in p:
            continue
        block = functools.partial(_decoder_block, cfg, mesh=mesh, moe=moe)
        for lp in _layers(p[name]):
            x, aux = _remat(block, lp, x, aux, cos, sin)
    return apply_norm(cfg.norm, p["final_norm"], x), aux


def _logits(cfg, p, h):
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return mm(h, w)


def _decoder_loss(cfg: ModelConfig, p, batch, mesh=None):
    h, aux = _decoder_hidden(cfg, p, batch, mesh)
    if cfg.vlm is not None:                      # loss on the text positions
        h = h[:, -batch["tokens"].shape[1]:]
    logits = _logits(cfg, p, h)
    return cross_entropy(logits, batch["labels"], batch.get("mask")) + aux


def _decoder_prefill(cfg: ModelConfig, p, batch, mesh=None):
    """Last-position logits and a ZERO cache of the prefill length, as the
    reference (enough for a dry run); ``BatchedServer`` never calls it:
    prompts go through ``decode_step`` one token at a time."""
    h, _ = _decoder_hidden(cfg, p, batch, mesh)
    logits = _logits(cfg, p, h[:, -1:])
    cache = _decoder_cache_from_prefill(cfg, p, batch, mesh)
    return logits, cache


def _decoder_cache_shapes(cfg: ModelConfig, B: int, S: int):
    first_k = cfg.moe.first_k_dense if cfg.moe else 0
    L = cfg.n_layers - first_k
    Sc = min(S, cfg.swa_window) if cfg.swa_window > 0 else S

    def mk(L_):
        if cfg.mla:
            m = cfg.mla
            return {"c": (L_, B, Sc, m.kv_lora_rank),
                    "r": (L_, B, Sc, m.rope_head_dim)}
        return {"k": (L_, B, Sc, cfg.n_kv_heads, cfg.head_dim),
                "v": (L_, B, Sc, cfg.n_kv_heads, cfg.head_dim)}

    out = {"layers": mk(L)}
    if first_k:
        out["dense_prefix"] = mk(first_k)
    return out


def _decoder_init_cache(cfg: ModelConfig, device: torch.device, B: int, S: int,
                        dtype: torch.dtype):
    return tree_map(
        lambda s: constrain_cache(torch.zeros(s, dtype=dtype, device=device),
                                  b_axis=1, s_axis=2),
        _decoder_cache_shapes(cfg, B, S))


def _decoder_cache_from_prefill(cfg, p, batch, mesh):
    B = batch["tokens"].shape[0]
    S = batch["tokens"].shape[1] + (cfg.vlm.n_patches if cfg.vlm else 0)
    return _decoder_init_cache(cfg, p["embed"].device, B, S,
                               dtype_of(cfg.compute_dtype))


def _onehot_write(c, rows, slot):
    """cache (L, B, S, ...) <- rows (L, B, 1, ...) at position ``slot``,
    () (one position for every row) or (B,) (per-row positions).
    ``rows`` must already be encoded in the cache dtype (encode_kv)."""
    S = c.shape[2]
    slotv = torch.atleast_1d(slot)                             # (B|1,)
    hit = torch.arange(S, device=c.device)[None] == slotv[:, None]
    hit = hit.reshape((1,) + tuple(hit.shape) + (1,) * (c.ndim - 3))
    if rows.dtype != c.dtype:
        raise TypeError(f"cache rows are {rows.dtype}, the cache {c.dtype}")
    return torch.where(hit, rows, c)


def _decoder_decode(cfg: ModelConfig, p, cache, tokens, pos, mesh=None):
    """tokens (B, 1) int; pos () int current position, or (B,) int
    per-row positions (continuous batching with staggered arrivals).

    Each layer attends to the OLD cache plus its fresh row; the cache is
    written once, after the whole stack, at the per-row positions (a
    write inside the layer loop would be another computation)."""
    x = p["embed"][tokens.long()]
    pos = torch.as_tensor(pos, device=x.device)
    # (B|1, 1, half): broadcasts over B for scalar pos, per-row otherwise
    cos, sin = rope_angles(torch.atleast_1d(pos)[:, None], _rope_dim(cfg),
                           cfg.rope_theta)
    attend = mla_decode if cfg.mla else gqa_decode

    def one_stack(x, stack_p, stack_cache, moe: bool):
        rows = []
        for i in range(_n_layers(stack_p)):
            lp, cl = _layer(stack_p, i), _layer(stack_cache, i)
            h = apply_norm(cfg.norm, lp["norm1"], x)
            a, r = attend(lp["attn"], h, cl, pos, cfg, cos, sin)
            x = x + a
            h = apply_norm(cfg.norm, lp["norm2"], x)
            if moe:
                y, _ = moe_forward(lp["mlp"], h, cfg, mesh=mesh)
            else:
                y = mlp_forward(lp["mlp"], h, cfg.activation)
            x = x + y
            rows.append(r)
        S = next(iter(stack_cache.values())).shape[2]
        slot = pos % S if cfg.swa_window > 0 else pos
        new_cache = {
            name: constrain_cache(
                _onehot_write(c, torch.stack([r[name] for r in rows]), slot),
                b_axis=1, s_axis=2)
            for name, c in stack_cache.items()}
        return x, new_cache

    new_cache = {}
    if "dense_prefix" in p:
        x, new_cache["dense_prefix"] = one_stack(
            x, p["dense_prefix"], cache["dense_prefix"], moe=False)
    x, new_cache["layers"] = one_stack(x, p["layers"], cache["layers"],
                                       moe=cfg.moe is not None)
    h = apply_norm(cfg.norm, p["final_norm"], x)
    return _logits(cfg, p, h), new_cache


# ===========================================================================
# encoder-decoder (Whisper backbone; the conv / mel frontend is a stub)
# ===========================================================================
def _init_encdec(cfg: ModelConfig, device: torch.device, seed_or_gen) -> Params:
    gen = _generator(seed_or_gen, device)
    dt = dtype_of(cfg.param_dtype)
    d, V = cfg.d_model, cfg.vocab
    e = cfg.encdec

    def norms(L):
        return {"scale": torch.ones((L, d), dtype=dt, device=device),
                "bias": torch.zeros((L, d), dtype=dt, device=device)}

    return {
        "embed": embed_init(gen, (V, d), dt),
        "enc": {
            "attn": init_gqa(gen, cfg, e.n_encoder_layers, dt),
            "mlp": init_mlp(gen, d, cfg.d_ff, e.n_encoder_layers, dt, "gelu"),
            "norm1": norms(e.n_encoder_layers),
            "norm2": norms(e.n_encoder_layers),
        },
        "enc_final": norms(1),
        "dec": {
            "attn": init_gqa(gen, cfg, e.n_decoder_layers, dt),
            "cross": init_cross(gen, cfg, e.n_decoder_layers, dt),
            "mlp": init_mlp(gen, d, cfg.d_ff, e.n_decoder_layers, dt, "gelu"),
            "norm1": norms(e.n_decoder_layers),
            "norm2": norms(e.n_decoder_layers),
            "norm3": norms(e.n_decoder_layers),
        },
        "dec_final": norms(1),
    }


def _slice_norm(n, i=0):
    return {"scale": n["scale"][i], "bias": n["bias"][i]}


def _enc_block(cfg, lp, x):
    h = apply_norm("layernorm", lp["norm1"], x)
    x = x + gqa_forward(lp["attn"], h, cfg, None, None, causal=False)
    h = apply_norm("layernorm", lp["norm2"], x)
    return x + mlp_forward(lp["mlp"], h, "gelu")


def _encode(cfg, p, frames):
    B, Se, d = frames.shape
    x = frames + _sinusoid(torch.arange(Se, device=frames.device),
                           d)[None].to(frames.dtype)
    for lp in _layers(p["enc"]):
        x = _remat(functools.partial(_enc_block, cfg), lp, x)
    return apply_norm("layernorm", _slice_norm(p["enc_final"]), x)


def _dec_block(cfg, lp, x, enc_out):
    h = apply_norm("layernorm", lp["norm1"], x)
    x = x + gqa_forward(lp["attn"], h, cfg, None, None, causal=True)
    h = apply_norm("layernorm", lp["norm2"], x)
    x = x + cross_forward(lp["cross"], h, cross_kv(lp["cross"], enc_out, cfg),
                          cfg)
    h = apply_norm("layernorm", lp["norm3"], x)
    return x + mlp_forward(lp["mlp"], h, "gelu")


def _encdec_loss(cfg: ModelConfig, p, batch, mesh=None):
    cdt = dtype_of(cfg.compute_dtype)
    enc_out = _encode(cfg, p, batch["frames"].to(cdt))
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = p["embed"][tokens.long()] + _sinusoid(
        torch.arange(S, device=enc_out.device), cfg.d_model)[None].to(cdt)
    for lp in _layers(p["dec"]):
        x = _remat(functools.partial(_dec_block, cfg), lp, x, enc_out)
    x = apply_norm("layernorm", _slice_norm(p["dec_final"]), x)
    logits = mm(x, p["embed"].T)
    return cross_entropy(logits, batch["labels"], batch.get("mask"))


def _encdec_prefill(cfg: ModelConfig, p, batch, mesh=None,
                    cache_len: int = 1024):
    """Encode the source and prime the decoder caches: the cross K/V of
    every decoder layer, a zero self cache of ``cache_len``.  The logits
    are the pre-decode BOS projection (the first real token comes from
    ``decode_step``)."""
    enc_out = _encode(cfg, p, batch["frames"].to(dtype_of(cfg.compute_dtype)))
    B = enc_out.shape[0]
    Ld = cfg.encdec.n_decoder_layers
    ck = [cross_kv(_layer(p["dec"]["cross"], i), enc_out, cfg)
          for i in range(Ld)]
    shape = (Ld, B, cache_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {
        "self": {name: constrain_cache(
            torch.zeros(shape, dtype=enc_out.dtype, device=enc_out.device),
            b_axis=1, s_axis=2) for name in ("k", "v")},
        "cross": {name: constrain_cache(torch.stack([c[name] for c in ck]),
                                        b_axis=1, s_axis=2)
                  for name in ("k", "v")},
    }
    bos = p["embed"][torch.zeros((B, 1), dtype=torch.long,
                                 device=enc_out.device)]
    logits = mm(apply_norm("layernorm", _slice_norm(p["dec_final"]), bos),
                p["embed"].T)
    return logits, cache


def _encdec_init_cache(cfg: ModelConfig, device: torch.device, B: int, S: int,
                       dtype: torch.dtype):
    """A self cache of length S and cross K/V over a source of length S."""
    Ld = cfg.encdec.n_decoder_layers
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "self": {"k": zeros(Ld, B, S, KH, hd), "v": zeros(Ld, B, S, KH, hd)},
        "cross": {"k": zeros(Ld, B, S, H, hd), "v": zeros(Ld, B, S, H, hd)},
    }


def _encdec_decode(cfg: ModelConfig, p, cache, tokens, pos, mesh=None):
    pos = torch.as_tensor(pos, device=p["embed"].device)
    # (B|1, 1, d) positional term: a scalar pos broadcasts, (B,) is per-row
    x = p["embed"][tokens.long()] + _sinusoid(
        torch.atleast_1d(pos), cfg.d_model)[:, None].to(
            dtype_of(cfg.compute_dtype))
    rows = []
    for i in range(_n_layers(p["dec"])):
        lp = _layer(p["dec"], i)
        self_c, cross_c = _layer(cache["self"], i), _layer(cache["cross"], i)
        h = apply_norm("layernorm", lp["norm1"], x)
        a, r = gqa_decode(lp["attn"], h, self_c, pos, cfg, None, None)
        x = x + a
        h = apply_norm("layernorm", lp["norm2"], x)
        x = x + cross_forward(lp["cross"], h, cross_c, cfg)
        h = apply_norm("layernorm", lp["norm3"], x)
        x = x + mlp_forward(lp["mlp"], h, "gelu")
        rows.append(r)
    self_new = {
        name: constrain_cache(
            _onehot_write(c, torch.stack([r[name] for r in rows]), pos),
            b_axis=1, s_axis=2)
        for name, c in cache["self"].items()}
    x = apply_norm("layernorm", _slice_norm(p["dec_final"]), x)
    return mm(x, p["embed"].T), {"self": self_new, "cross": cache["cross"]}


# ===========================================================================
# SSM / hybrid (Mamba2, Zamba2)
# ===========================================================================
def _mamba_block(cfg, lp, norm, x):
    return x + ssm_mod.mamba_forward(lp, apply_norm("rmsnorm", norm, x), cfg)


def _shared_block(cfg, p, x, cos, sin):
    h = apply_norm("rmsnorm", p["shared_norm1"], x)
    x = x + gqa_forward(p["shared_attn"], h, cfg, cos, sin, causal=True)
    h = apply_norm("rmsnorm", p["shared_norm2"], x)
    return x + mlp_forward(p["shared_mlp"], h, "silu")


def _hybrid_forward(cfg: ModelConfig, p, x, mesh=None):
    g, k, rest = ssm_mod.hybrid_layout(cfg)
    layers = _layers(p["mamba"])
    norms = p["norm"].unbind(0)
    block = functools.partial(_mamba_block, cfg)

    def run_slice(x, lo, hi):
        for i in range(lo, hi):
            x = _remat(block, layers[i], norms[i], x)
        return x

    if g > 0:
        S = x.shape[1]
        cos, sin = rope_angles(torch.arange(S, device=x.device), cfg.head_dim,
                               cfg.rope_theta)
        shared = {name: p[name] for name in (
            "shared_attn", "shared_mlp", "shared_norm1", "shared_norm2")}
        for gi in range(g):
            x = run_slice(x, gi * k, (gi + 1) * k)
            x = _remat(functools.partial(_shared_block, cfg), shared, x, cos,
                       sin)
        if rest:
            x = run_slice(x, g * k, g * k + rest)
    else:
        x = run_slice(x, 0, cfg.n_layers)
    return x


def _init_ssm(cfg: ModelConfig, device: torch.device, seed_or_gen) -> Params:
    gen = _generator(seed_or_gen, device)
    dt = dtype_of(cfg.param_dtype)
    p = ssm_mod.init_hybrid(gen, cfg, dt)
    p["embed"] = embed_init(gen, (cfg.vocab, cfg.d_model), dt)
    p["final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt,
                                  fan_in=cfg.d_model)
    return p


def _ssm_loss(cfg, p, batch, mesh=None):
    x = p["embed"][batch["tokens"].long()]
    x = _hybrid_forward(cfg, p, x, mesh)
    x = apply_norm("rmsnorm", p["final_norm"], x)
    return cross_entropy(_logits(cfg, p, x), batch["labels"], batch.get("mask"))


def _ssm_init_cache(cfg: ModelConfig, device: torch.device, B: int, S: int,
                    dtype: torch.dtype):
    """The f32 SSM state and the conv window of every layer; the shared
    block's K/V of every group."""
    di, H, ds, K = ssm_mod._mamba_dims(cfg)
    hd = cfg.ssm.head_dim
    g, k, rest = ssm_mod.hybrid_layout(cfg)
    cache = {
        "ssm": torch.zeros((cfg.n_layers, B, H, ds, hd), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((cfg.n_layers, B, K - 1, di + 2 * ds),
                            dtype=dtype, device=device),
    }
    if g > 0:
        cache["attn"] = {name: constrain_cache(torch.zeros(
            (g, B, S, cfg.n_kv_heads, cfg.head_dim), dtype=dtype,
            device=device), b_axis=1, s_axis=2) for name in ("k", "v")}
    return cache


def _ssm_prefill(cfg, p, batch, mesh=None):
    """Last-position logits and a ZERO cache, as the reference: the
    prompt's recurrent state is not carried into decode."""
    x = p["embed"][batch["tokens"].long()]
    x = _hybrid_forward(cfg, p, x, mesh)
    x = apply_norm("rmsnorm", p["final_norm"], x)
    logits = _logits(cfg, p, x[:, -1:])
    B, S = batch["tokens"].shape
    return logits, _ssm_init_cache(cfg, x.device, B, S,
                                   dtype_of(cfg.compute_dtype))


def _ssm_decode(cfg: ModelConfig, p, cache, tokens, pos, mesh=None):
    g, k, rest = ssm_mod.hybrid_layout(cfg)
    x = p["embed"][tokens.long()]
    pos = torch.as_tensor(pos, device=x.device)
    cos, sin = None, None
    if g > 0:
        cos, sin = rope_angles(torch.atleast_1d(pos)[:, None], cfg.head_dim,
                               cfg.rope_theta)
    new_ssm, new_conv, new_k, new_v = [], [], [], []

    def mamba_slice(x, lo, hi):
        for i in range(lo, hi):
            y, st = ssm_mod.mamba_step(
                _layer(p["mamba"], i), apply_norm("rmsnorm", p["norm"][i], x),
                {"ssm": cache["ssm"][i], "conv": cache["conv"][i]}, cfg)
            x = x + y
            new_ssm.append(st["ssm"])
            new_conv.append(st["conv"])
        return x

    if g > 0:
        for gi in range(g):
            x = mamba_slice(x, gi * k, (gi + 1) * k)
            h = apply_norm("rmsnorm", p["shared_norm1"], x)
            kv = {"k": cache["attn"]["k"][gi], "v": cache["attn"]["v"][gi]}
            a, rows = gqa_decode(p["shared_attn"], h, kv, pos, cfg, cos, sin)
            x = x + a
            h = apply_norm("rmsnorm", p["shared_norm2"], x)
            x = x + mlp_forward(p["shared_mlp"], h, "silu")
            new_k.append(_onehot_write(kv["k"][None], rows["k"][None], pos)[0])
            new_v.append(_onehot_write(kv["v"][None], rows["v"][None], pos)[0])
        if rest:
            x = mamba_slice(x, g * k, g * k + rest)
    else:
        x = mamba_slice(x, 0, cfg.n_layers)
    new_cache = {"ssm": torch.stack(new_ssm), "conv": torch.stack(new_conv)}
    if g > 0:
        new_cache["attn"] = {
            "k": constrain_cache(torch.stack(new_k), b_axis=1, s_axis=2),
            "v": constrain_cache(torch.stack(new_v), b_axis=1, s_axis=2)}
    x = apply_norm("rmsnorm", p["final_norm"], x)
    return _logits(cfg, p, x), new_cache


# ===========================================================================
# xLSTM
# ===========================================================================
def _init_xlstm(cfg: ModelConfig, device: torch.device, seed_or_gen) -> Params:
    gen = _generator(seed_or_gen, device)
    dt = dtype_of(cfg.param_dtype)
    g, m = xlstm_mod.xlstm_layout(cfg)
    p = {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dt),
        "mlstm": xlstm_mod.init_mlstm(gen, cfg, g * m, dt),
        "slstm": xlstm_mod.init_slstm(gen, cfg, g, dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt,
                                  fan_in=cfg.d_model)
    return p


def _xlstm_forward(cfg, p, x):
    g, m = xlstm_mod.xlstm_layout(cfg)
    mlstm, slstm = _layers(p["mlstm"]), _layers(p["slstm"])
    for gi in range(g):
        for i in range(gi * m, (gi + 1) * m):
            x = _remat(lambda lp, x: xlstm_mod.mlstm_forward(lp, x, cfg),
                       mlstm[i], x)
        x = _remat(lambda lp, x: xlstm_mod.slstm_forward(lp, x, cfg),
                   slstm[gi], x)
    return x


def _xlstm_loss(cfg, p, batch, mesh=None):
    x = _xlstm_forward(cfg, p, p["embed"][batch["tokens"].long()])
    x = rmsnorm(p["final_norm"], x)
    return cross_entropy(_logits(cfg, p, x), batch["labels"], batch.get("mask"))


def _xlstm_init_cache(cfg: ModelConfig, device: torch.device, B: int, S: int,
                      dtype: torch.dtype):
    """Recurrent state only (``S`` unused): the f32 mLSTM matrix memory
    (value and normaliser columns), the sLSTM's ``h`` in ``dtype`` and its
    f32 ``c`` / ``n``."""
    del S
    g, m = xlstm_mod.xlstm_layout(cfg)
    di, H, hd = xlstm_mod._mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "mlstm": torch.zeros((g * m, B, H, hd, 2 * hd), dtype=f32,
                             device=device),
        "slstm_h": torch.zeros((g, B, cfg.d_model), dtype=dtype, device=device),
        "slstm_c": torch.zeros((g, B, cfg.d_model), dtype=f32, device=device),
        "slstm_n": torch.zeros((g, B, cfg.d_model), dtype=f32, device=device),
    }


def _xlstm_prefill(cfg, p, batch, mesh=None):
    """Last-position logits and a ZERO state, as the reference: the
    prompt's recurrent state is not carried into decode."""
    x = _xlstm_forward(cfg, p, p["embed"][batch["tokens"].long()])
    logits = _logits(cfg, p, rmsnorm(p["final_norm"], x[:, -1:]))
    B, S = batch["tokens"].shape
    return logits, _xlstm_init_cache(cfg, x.device, B, S,
                                     dtype_of(cfg.compute_dtype))


def _xlstm_decode(cfg, p, cache, tokens, pos, mesh=None):
    del pos
    g, m = xlstm_mod.xlstm_layout(cfg)
    x = p["embed"][tokens.long()]
    new_m, new_h, new_c, new_n = [], [], [], []
    for gi in range(g):
        for i in range(gi * m, (gi + 1) * m):
            x, st = xlstm_mod.mlstm_step(_layer(p["mlstm"], i), x,
                                         cache["mlstm"][i], cfg)
            new_m.append(st)
        st = (cache["slstm_h"][gi], cache["slstm_c"][gi], cache["slstm_n"][gi])
        x, (h, c, n) = xlstm_mod.slstm_step(_layer(p["slstm"], gi), x, st, cfg)
        new_h.append(h)
        new_c.append(c)
        new_n.append(n)
    logits = _logits(cfg, p, rmsnorm(p["final_norm"], x))
    return logits, {"mlstm": torch.stack(new_m), "slstm_h": torch.stack(new_h),
                    "slstm_c": torch.stack(new_c),
                    "slstm_n": torch.stack(new_n)}


def _with_ctx(fn):
    """Install the mesh sharding-hint context around a step entry point,
    with bf16 products accumulating in f32 (``f32_accumulation``)."""
    @functools.wraps(fn)
    def wrapped(*args, mesh=None, **kw):
        with use_mesh(mesh), torch.no_grad(), f32_accumulation():
            return fn(*args, mesh=mesh, **kw)
    return wrapped


def value_and_grad(model: Model, params, batch, mesh=None, remat: bool = True):
    """``jax.value_and_grad(model.loss)(params, batch)``: ``(loss, grads)``,
    ``grads`` a tree like ``params`` in each leaf's dtype (bf16 leaves get
    bf16 gradients; a leaf the loss does not reach gets zeros).

    The forward and the backward both run under the mesh context and
    :func:`~repro_torch.models.common.f32_accumulation` (the backward's
    bf16 GEMMs too), with every layer rematerialised (``remat``: its
    activations recomputed in the backward, ``torch.utils.checkpoint``;
    ``remat=False`` keeps them, with the same bits)."""
    with use_mesh(mesh), torch.enable_grad(), f32_accumulation(), \
            _remat_layers(remat):
        p = tree_map(lambda a: a.detach().requires_grad_(), params)
        leaves = tree_leaves(p)
        loss = model.loss_fn(p, batch, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(a): torch.zeros_like(a) if g is None else g
               for a, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda a: by_leaf[id(a)], p)


# ===========================================================================
def build_model(cfg: ModelConfig, device=None) -> Model:
    """The family's :class:`Model` on ``device`` (None: CUDA; ``"meta"``:
    shapes and dtypes only, for the dry run), dispatched in the
    reference's order: xLSTM, SSM / hybrid, encoder-decoder, then the
    decoder (dense, MoE, VLM, MLA)."""
    cfg.validate()
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    if cfg.xlstm is not None:
        fns = (_init_xlstm, _xlstm_loss, _xlstm_prefill, _xlstm_decode,
               _xlstm_init_cache)
    elif cfg.family in ("ssm", "hybrid"):
        fns = (_init_ssm, _ssm_loss, _ssm_prefill, _ssm_decode,
               _ssm_init_cache)
    elif cfg.family == "encdec":
        fns = (_init_encdec, _encdec_loss, _encdec_prefill, _encdec_decode,
               _encdec_init_cache)
    else:
        fns = (_init_decoder, _decoder_loss, _decoder_prefill,
               _decoder_decode, _decoder_init_cache)
    init, loss, prefill, decode, init_cache = fns
    return Model(cfg, functools.partial(init, cfg, dev),
                 _with_ctx(functools.partial(loss, cfg)),
                 _with_ctx(functools.partial(prefill, cfg)),
                 _with_ctx(functools.partial(decode, cfg)),
                 functools.partial(init_cache, cfg, dev),
                 dev, functools.partial(loss, cfg))
