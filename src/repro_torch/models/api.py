"""Model API of the decoder family (port of ``repro.models.api``).

``build_model(cfg, device=None)`` returns a :class:`Model` with:

* ``init(seed_or_generator) -> params``  (stacked-per-layer nested dict)
* ``loss(params, batch, mesh=None) -> scalar``  (next-token CE + MoE aux;
  the forward value only)
* ``prefill(params, batch, mesh=None) -> (logits_last, cache)``
* ``decode_step(params, cache, tokens, pos, mesh=None) -> (logits, cache)``
* ``init_cache(batch, cache_len, dtype) -> cache``  (zeros)

The decoder family: dense GQA transformers, MoE and VLM backbones.  Layers
loop in Python over the stacked ``(L, ...)`` parameters, eagerly (the
reference's ``lax.scan``).  MLA, the SSM / hybrid stacks, xLSTM and the
encoder-decoder wait for their slices: ``build_model`` raises for them.
Everything runs on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from ..core.replay import resolve_device
from .attention import gqa_decode, gqa_forward, init_gqa
from .common import (
    apply_norm,
    cross_entropy,
    dense_init,
    dtype_of,
    embed_init,
    f32_accumulation,
    make_norm,
    mm,
    rope_angles,
    tree_map,
)
from .config import ModelConfig
from .mlp import init_mlp, init_moe, mlp_forward, moe_forward
from .shard_ctx import constrain, constrain_cache, use_mesh

Params = Any

#: the families that wait for a later slice, and the ROADMAP item that
#: ports each (queue 1, item 6: the remaining model families)
WAITING = {
    "mla": "MLA attention (deepseek-v2-236b)",
    "ssm": "the SSM / hybrid stacks (zamba2-1.2b: ssm.py, linear_attn.py)",
    "xlstm": "xLSTM (xlstm-125m)",
    "encdec": "the encoder-decoder (whisper-tiny)",
}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    device: torch.device = torch.device("cuda")


def _generator(seed_or_gen, device: torch.device) -> torch.Generator:
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


# ===========================================================================
# decoder-only transformers (dense / MoE / VLM)
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
            "attn": init_gqa(gen, cfg, L, dt),
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
    a = gqa_forward(lp["attn"], h, cfg, cos, sin)
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
    cos, sin = rope_angles(torch.arange(S, device=x.device), cfg.head_dim,
                           cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stacks = (("dense_prefix", False), ("layers", cfg.moe is not None))
    for name, moe in stacks:
        if name not in p:
            continue
        for i in range(_n_layers(p[name])):
            x, aux = _decoder_block(cfg, _layer(p[name], i), x, aux, cos, sin,
                                    mesh=mesh, moe=moe)
    return apply_norm(cfg.norm, p["final_norm"], x), aux


def _logits(cfg, p, h):
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return mm(h, w)


def _decoder_loss(cfg: ModelConfig, p, batch, mesh=None):
    """The loss value (no gradient in this slice)."""
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
    cos, sin = rope_angles(torch.atleast_1d(pos)[:, None], cfg.head_dim,
                           cfg.rope_theta)

    def one_stack(x, stack_p, stack_cache, moe: bool):
        rows = []
        for i in range(_n_layers(stack_p)):
            lp, cl = _layer(stack_p, i), _layer(stack_cache, i)
            h = apply_norm(cfg.norm, lp["norm1"], x)
            a, r = gqa_decode(lp["attn"], h, cl, pos, cfg, cos, sin)
            x = x + a
            h = apply_norm(cfg.norm, lp["norm2"], x)
            if moe:
                y, _ = moe_forward(lp["mlp"], h, cfg, mesh=mesh)
            else:
                y = mlp_forward(lp["mlp"], h, cfg.activation)
            x = x + y
            rows.append(r)
        S = stack_cache["k"].shape[2]
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


def _with_ctx(fn):
    """Install the mesh sharding-hint context around a step entry point,
    with bf16 products accumulating in f32 (``f32_accumulation``)."""
    @functools.wraps(fn)
    def wrapped(*args, mesh=None, **kw):
        with use_mesh(mesh), torch.no_grad(), f32_accumulation():
            return fn(*args, mesh=mesh, **kw)
    return wrapped


def _waiting_family(cfg: ModelConfig) -> str | None:
    if cfg.mla is not None:
        return "mla"
    if cfg.xlstm is not None:
        return "xlstm"
    if cfg.family in ("ssm", "hybrid"):
        return "ssm"
    if cfg.family == "encdec":
        return "encdec"
    return None


# ===========================================================================
def build_model(cfg: ModelConfig, device=None) -> Model:
    """The decoder family's :class:`Model` on ``device`` (None: CUDA)."""
    cfg.validate()
    fam = _waiting_family(cfg)
    if fam is not None:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet ({WAITING[fam]}; ROADMAP, queue 1, "
            "item 6: the remaining model families)")
    dev = resolve_device(device)
    return Model(cfg, functools.partial(_init_decoder, cfg, dev),
                 _with_ctx(functools.partial(_decoder_loss, cfg)),
                 _with_ctx(functools.partial(_decoder_prefill, cfg)),
                 _with_ctx(functools.partial(_decoder_decode, cfg)),
                 functools.partial(_decoder_init_cache, cfg, dev),
                 dev)
