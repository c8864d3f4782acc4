"""Attention: GQA (dense + chunked online-softmax) and sliding windows.

The port of ``repro.models.attention``'s GQA part.  Conventions:

* q (B, Sq, H, Dk), k (B, Sk, KH, Dk), v (B, Sk, KH, Dv); H = KH * G;
* training/prefill use :func:`attention_core` (dense (S, S) scores, or the
  chunked online-softmax loop over the non-masked block pairs);
* decode attends to the OLD cache plus the fresh row
  (:func:`decode_attend`); the caller writes the cache once after the
  whole layer stack;
* sliding-window archs (h2o-danube) keep a RING-BUFFER cache of window
  size.

The arithmetic is the reference's explicit f32 softmax (no
``scaled_dot_product_attention``), so the port's numbers follow it.  MLA
(DeepSeek-V2's latent attention: a decompressed prefill and the absorbed
decode over the latent cache ``c`` / ``r``) and the Whisper decoder's
cross-attention follow the GQA block.
"""
from __future__ import annotations

import torch

from .common import apply_rope, clip, dense_init, einsum, mm, rmsnorm
from .config import ModelConfig
from .shard_ctx import constrain, constrain_cache

NEG_INF = -1e30
KV_SCALE = 24.0       # fixed symmetric int8 scale for quantised KV caches


def encode_kv(x, dtype):
    """Round half to even (``torch.round`` as ``jnp.round``) at
    ``KV_SCALE``, clipped to +-127, for an int8 cache; a cast otherwise."""
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.float() * KV_SCALE),
                           -127, 127).to(torch.int8)
    return x.to(dtype)


def decode_kv(x):
    if x.dtype == torch.int8:
        return (x.float() * (1.0 / KV_SCALE)).to(torch.bfloat16)
    return x


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------
def _mask(qpos, kpos, causal: bool, window: int):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def expand_kv(k, n_heads: int):
    """(B, S, KH, D) -> (B, S, H, D): repeat each KV head over its group."""
    B, S, KH, D = k.shape
    if KH == n_heads:
        return k
    G = n_heads // KH
    k = k[:, :, :, None].expand(B, S, KH, G, D)
    return k.reshape(B, S, n_heads, D)


def attention_dense(q, k, v, *, causal: bool, window: int, q0: int = 0, k0: int = 0,
                    scale: float | None = None):
    """Materialised-scores attention (q/k/v all (B, S, H, D))."""
    B, Sq, H, Dk = q.shape
    scale = scale if scale is not None else Dk ** -0.5
    s = einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = constrain(s, ("dp", "model", None, None))
    qpos = q0 + torch.arange(Sq, device=q.device)
    kpos = k0 + torch.arange(k.shape[1], device=q.device)
    m = _mask(qpos, kpos, causal, window)
    s = torch.where(m[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return einsum("bhqk,bkhd->bqhd", p, v)


def _chunk_pairs(nq: int, nk: int, causal: bool, window: int, chunk: int):
    """Static (qi, kj) block list, SKIPPING fully-masked blocks."""
    pq, pk = [], []
    for qi in range(nq):
        for kj in range(nk):
            if causal and kj > qi:
                continue                       # strictly-future block
            if window > 0 and (qi - kj) * chunk >= window + chunk:
                continue                       # fully outside the window
            pq.append(qi)
            pk.append(kj)
    return pq, pk


def attention_chunked(q, k, v, *, causal: bool, window: int, chunk: int,
                      scale: float | None = None):
    """Online-softmax attention, O(chunk^2) live scores (flash-style).

    A Python loop over the static list of non-masked (q-chunk, kv-chunk)
    block pairs (the reference's ``scan``), in the reference's order and
    dtypes.  Each q-chunk's running (max, sum, acc) statistics are tensors
    of their own, replaced at every block and stacked at the end: nothing
    is written in place, so autograd keeps what it saved.
    """
    B, Sq, H, Dk = q.shape
    Sk = k.shape[1]
    Dv = v.shape[-1]
    scale = scale if scale is not None else Dk ** -0.5
    if Sq % chunk or Sk % chunk:
        raise ValueError(f"sequence lengths {(Sq, Sk)} must be multiples of "
                         f"the chunk {chunk}")
    nq, nk = Sq // chunk, Sk // chunk
    qc = q.reshape(B, nq, chunk, H, Dk).transpose(0, 1)
    kc = k.reshape(B, nk, chunk, H, Dk).transpose(0, 1)
    vc = v.reshape(B, nk, chunk, H, Dv).transpose(0, 1)
    pq, pk = _chunk_pairs(nq, nk, causal, window, chunk)

    dev = q.device
    m = [torch.full((B, H, chunk), NEG_INF, dtype=torch.float32, device=dev)
         ] * nq
    l = [torch.zeros((B, H, chunk), dtype=torch.float32, device=dev)] * nq
    acc = [torch.zeros((B, H, chunk, Dv), dtype=torch.float32, device=dev)
           ] * nq
    ar = torch.arange(chunk, device=dev)
    for qi, kj in zip(pq, pk):
        s = einsum("bqhd,bkhd->bhqk", qc[qi], kc[kj]).float() * scale
        msk = _mask(qi * chunk + ar, kj * chunk + ar, causal, window)
        s = torch.where(msk[None, None], s, NEG_INF)
        m_q, l_q, a_q = m[qi], l[qi], acc[qi]
        m_new = torch.maximum(m_q, s.amax(dim=-1))
        # clip: fully-masked rows keep m at NEG_INF and must not revive
        corr = torch.exp(clip(m_q - m_new, -80.0, 0.0))
        p = torch.exp(clip(s - m_new[..., None], -80.0, 0.0))
        p = torch.where(msk[None, None], p, 0.0)
        l_new = l_q * corr + p.sum(dim=-1)
        pv = einsum("bhqk,bkhd->bhqd", p.to(vc.dtype), vc[kj])
        a_new = a_q * corr[..., None] + pv.float()
        m[qi], l[qi], acc[qi] = m_new, l_new, a_new
    # (nq, B, H, chunk, Dv)
    o = torch.stack(acc) / clip(torch.stack(l)[..., None], 1e-30)
    o = o.permute(1, 0, 3, 2, 4).reshape(B, Sq, H, Dv)
    return o.to(v.dtype)


def attention_core(q, k, v, cfg: ModelConfig, *, causal: bool, window: int = 0,
                   scale: float | None = None):
    if cfg.attn_impl == "chunked" and q.shape[1] > cfg.attn_chunk:
        return attention_chunked(
            q, k, v, causal=causal, window=window, chunk=cfg.attn_chunk, scale=scale
        )
    return attention_dense(q, k, v, causal=causal, window=window, scale=scale)


def decode_attend(q, k_cache, v_cache, k_new, v_new, pos, *, window: int = 0,
                  scale: float | None = None):
    """Single-token attention: OLD cache (positions < pos) + the current
    token's fresh k/v appended explicitly.  The caller writes (k_new,
    v_new) into the cache after the whole layer stack.

    q (B, H, Dk); caches (B, S, KH, D*); k_new/v_new (B, KH, D*); pos ()
    scalar or (B,) per-row positions (continuous batching).
    ``window > 0``: the cache is a ring buffer of size S == window; the
    absolute position of slot i is the latest p <= pos-ish with p % S == i.
    """
    B, S, KH, Dk = k_cache.shape
    H = q.shape[1]
    G = H // KH
    scale = scale if scale is not None else Dk ** -0.5
    qg = q.reshape(B, KH, G, Dk)
    s = einsum("bhgd,bkhd->bhgk", qg, k_cache).float() * scale
    s = constrain_cache(s, b_axis=0, s_axis=3)
    posv = torch.atleast_1d(pos)[:, None]                  # (B|1, 1)
    slot = torch.arange(S, device=q.device)[None]          # (1, S)
    if window > 0:
        # ring-buffer SWA: floor division of the (possibly negative)
        # distance, as ``//`` on jnp integers
        kpos = slot + torch.div(posv - slot, S, rounding_mode="floor") * S
        valid = (kpos >= 0) & (kpos < posv) & (kpos > posv - window)
    else:
        valid = slot < posv                                # (B|1, S)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    s_cur = einsum("bhgd,bhd->bhg", qg, k_new).float() * scale
    m_loc = torch.maximum(s.amax(dim=-1), s_cur)
    p = torch.exp(s - m_loc[..., None])
    p_cur = torch.exp(s_cur - m_loc)
    l = p.sum(dim=-1) + p_cur
    # dtype promotion: p is cast to the cache dtype before the PV product,
    # and the fresh row's term promotes with v_new's dtype, as in JAX
    o = einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    o = o + p_cur[..., None].to(v_new.dtype) * v_new[:, :, None]
    o = o / l[..., None].to(o.dtype)
    return o.reshape(B, H, v_cache.shape[-1])


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------
def init_gqa(gen: torch.Generator, cfg: ModelConfig, L: int, dtype) -> dict:
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (L, d, H * hd), dtype, fan_in=d),
        "wk": dense_init(gen, (L, d, KH * hd), dtype, fan_in=d),
        "wv": dense_init(gen, (L, d, KH * hd), dtype, fan_in=d),
        "wo": dense_init(gen, (L, H * hd, d), dtype, fan_in=H * hd),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KH * hd), ("bv", KH * hd)):
            p[name] = torch.zeros((L, width), dtype=dtype, device=gen.device)
    return p


def gqa_qkv(p, x, cfg: ModelConfig, cos, sin):
    B, S, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = mm(x, p["wq"])
    k = mm(x, p["wk"])
    v = mm(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KH, hd)
    v = v.reshape(B, S, KH, hd)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def gqa_forward(p, x, cfg: ModelConfig, cos, sin, *, causal: bool = True):
    q, k, v = gqa_qkv(p, x, cfg, cos, sin)
    q = constrain(q, ("dp", None, "model", None))
    k = constrain(expand_kv(k, cfg.n_heads), ("dp", None, "model", None))
    v = constrain(expand_kv(v, cfg.n_heads), ("dp", None, "model", None))
    o = attention_core(q, k, v, cfg, causal=causal, window=cfg.swa_window)
    B, S = x.shape[:2]
    return mm(o.reshape(B, S, -1), p["wo"])


def gqa_decode(p, x, cache, pos, cfg: ModelConfig, cos, sin):
    """x (B, 1, d); cache {k, v} (B, S_cache, KH, hd); pos () or (B,).

    Returns (y, {k, v} NEW-TOKEN rows (B, 1, KH, hd)) in the cache dtype;
    the caller performs the single post-stack cache write."""
    B = x.shape[0]
    q, k, v = gqa_qkv(p, x, cfg, cos, sin)            # S = 1
    o = decode_attend(q[:, 0], decode_kv(cache["k"]), decode_kv(cache["v"]),
                      k[:, 0], v[:, 0], pos, window=cfg.swa_window)
    y = mm(o.reshape(B, 1, -1), p["wo"])
    ct = cache["k"].dtype
    return y, {"k": encode_kv(k, ct), "v": encode_kv(v, ct)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 Multi-head Latent Attention)
# ---------------------------------------------------------------------------
def init_mla(gen: torch.Generator, cfg: ModelConfig, L: int, dtype) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.nope_head_dim + m.rope_head_dim
    return {
        "wq_a": dense_init(gen, (L, d, m.q_lora_rank), dtype, fan_in=d),
        "q_norm": torch.ones((L, m.q_lora_rank), dtype=dtype,
                             device=gen.device),
        "wq_b": dense_init(gen, (L, m.q_lora_rank, H * qk), dtype,
                           fan_in=m.q_lora_rank),
        "wkv_a": dense_init(gen, (L, d, m.kv_lora_rank + m.rope_head_dim),
                            dtype, fan_in=d),
        "kv_norm": torch.ones((L, m.kv_lora_rank), dtype=dtype,
                              device=gen.device),
        "wkv_b": dense_init(
            gen, (L, m.kv_lora_rank, H * (m.nope_head_dim + m.v_head_dim)),
            dtype, fan_in=m.kv_lora_rank),
        "wo": dense_init(gen, (L, H * m.v_head_dim, d), dtype,
                         fan_in=H * m.v_head_dim),
    }


def _mla_q(p, x, cfg, cos, sin):
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    cq = rmsnorm(p["q_norm"], mm(x, p["wq_a"]))
    q = mm(cq, p["wq_b"]).reshape(B, S, H, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., : m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = apply_rope(q_rope, cos, sin)
    return q_nope, q_rope


def mla_forward(p, x, cfg: ModelConfig, cos, sin, *, causal: bool = True):
    """Prefill / training MLA: decompress K/V, then standard attention."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(p, x, cfg, cos, sin)
    ckv = mm(x, p["wkv_a"])
    c_kv = rmsnorm(p["kv_norm"], ckv[..., : m.kv_lora_rank])
    k_rope = apply_rope(ckv[..., None, m.kv_lora_rank:], cos, sin)  # 1 head
    kv = mm(c_kv, p["wkv_b"]).reshape(B, S, H,
                                      m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., : m.nope_head_dim], kv[..., m.nope_head_dim:]
    q = constrain(torch.cat([q_nope, q_rope], dim=-1),
                  ("dp", None, "model", None))
    k = constrain(
        torch.cat([k_nope, k_rope.expand(
            k_nope.shape[:-1] + (m.rope_head_dim,))], dim=-1),
        ("dp", None, "model", None))
    v = constrain(v, ("dp", None, "model", None))
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    o = attention_core(q, k, v, cfg, causal=causal, scale=scale)
    return mm(o.reshape(B, S, -1), p["wo"])


def mla_decode(p, x, cache, pos, cfg: ModelConfig, cos, sin):
    """Absorbed-form MLA decode over the COMPRESSED latent cache (``c``
    (B, S, kv_lora_rank), ``r`` (B, S, rope_head_dim)), with W_UK / W_UV
    folded into the score and output products.

    Scores in f32, scaled by ``(nope + rope) ** -0.5``; the old cache
    counts where ``slot < pos`` (strict), the current token is its own
    term; the probabilities are cast to the cache dtype before the latent
    products.  Returns (y, {c, r} NEW-TOKEN rows (B, 1, *)) for the
    caller's single post-stack write."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(p, x, cfg, cos, sin)        # (B, 1, H, *)
    ckv = mm(x, p["wkv_a"])                             # (B, 1, rank+rope)
    c_kv = rmsnorm(p["kv_norm"], ckv[..., : m.kv_lora_rank])
    k_rope = apply_rope(ckv[..., None, m.kv_lora_rank:], cos, sin)[:, :, 0]
    w_uk = p["wkv_b"].reshape(m.kv_lora_rank, H,
                              m.nope_head_dim + m.v_head_dim)
    w_k = w_uk[..., : m.nope_head_dim]                  # (rank, H, nope)
    w_v = w_uk[..., m.nope_head_dim:]                   # (rank, H, v)
    # absorb: q_eff = q_nope @ W_UK^T -> scores in the latent space
    q_eff = einsum("bhd,rhd->bhr", q_nope[:, 0], w_k)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    s = (einsum("bhr,bsr->bhs", q_eff, cache["c"])
         + einsum("bhd,bsd->bhs", q_rope[:, 0], cache["r"])).float() * scale
    S = cache["c"].shape[1]
    s = constrain_cache(s, b_axis=0, s_axis=2)
    valid = (torch.arange(S, device=x.device)[None]
             < torch.atleast_1d(pos)[:, None])          # (B|1, S)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    s_cur = (einsum("bhr,br->bh", q_eff, c_kv[:, 0])
             + einsum("bhd,bd->bh", q_rope[:, 0], k_rope[:, 0])
             ).float() * scale
    s_all = torch.cat([s, s_cur[..., None]], dim=-1)
    pr = torch.softmax(s_all, dim=-1).to(cache["c"].dtype)
    pr_s = constrain_cache(pr[..., :S], b_axis=0, s_axis=2)
    o_lat = einsum("bhs,bsr->bhr", pr_s, cache["c"])
    o_lat = o_lat + pr[..., S:] * c_kv                  # current-token term
    o = einsum("bhr,rhd->bhd", o_lat, w_v)              # (B, H, v)
    y = mm(o.reshape(B, 1, -1), p["wo"])
    return y, {"c": c_kv, "r": k_rope}


# ---------------------------------------------------------------------------
# cross-attention (Whisper decoder)
# ---------------------------------------------------------------------------
def init_cross(gen: torch.Generator, cfg: ModelConfig, L: int, dtype) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (L, d, H * hd), dtype, fan_in=d),
        "wk": dense_init(gen, (L, d, H * hd), dtype, fan_in=d),
        "wv": dense_init(gen, (L, d, H * hd), dtype, fan_in=d),
        "wo": dense_init(gen, (L, H * hd, d), dtype, fan_in=H * hd),
    }


def cross_forward(p, x, enc_kv, cfg: ModelConfig):
    """x (B, S, d) attends to precomputed encoder K/V (B, Se, H, hd)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = constrain(mm(x, p["wq"]).reshape(B, S, H, hd),
                  ("dp", None, "model", None))
    o = attention_core(q, enc_kv["k"], enc_kv["v"], cfg, causal=False)
    return mm(o.reshape(B, S, -1), p["wo"])


def cross_kv(p, enc_out, cfg: ModelConfig):
    B, Se, _ = enc_out.shape
    H, hd = cfg.n_heads, cfg.head_dim
    return {
        "k": mm(enc_out, p["wk"]).reshape(B, Se, H, hd),
        "v": mm(enc_out, p["wv"]).reshape(B, Se, H, hd),
    }
