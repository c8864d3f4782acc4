"""Mamba-2 (SSD) blocks and the Zamba2-style hybrid stack (port of
``repro.models.ssm``).

Mamba-2 block (n_groups = 1): ``in_proj`` packs [z (di) | x (di) | B (ds)
| C (ds) | dt (H)]; a depthwise causal conv over the [x|B|C] channels; the
SSD recurrence through the chunked linear attention (q = C, k = B, v = the
x heads, log_f = -dt * exp(A_log), gain dt); the D skip; a SiLU(z) gate;
``out_proj``.

Zamba2 hybrid: ``n_layers`` Mamba-2 layers with ONE shared attention block
(GQA + SwiGLU MLP, the same weights every time) after every
``shared_attn_every`` SSM layers.

The convolution rounds differently in its two paths, as in the reference:
the prefill adds one tap at a time in the input dtype
(:func:`_causal_depthwise_conv`), the decode step takes one einsum over
the window (:func:`mamba_step`).  Each is ported as written.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import init_gqa
from .common import dense_init, einsum, mm, rmsnorm, silu, tree_map
from .config import ModelConfig
from .linear_attn import chunked_linear_attention, linear_attention_step
from .mlp import init_mlp
from .shard_ctx import constrain


def _mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    H = di // s.head_dim
    return di, H, s.d_state, s.d_conv


def init_mamba(gen: torch.Generator, cfg: ModelConfig, L: int, dtype) -> dict:
    d = cfg.d_model
    di, H, ds, _ = _mamba_dims(cfg)
    proj_out = 2 * di + 2 * ds + H
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (L, d, proj_out), dtype, fan_in=d),
        "conv_w": dense_init(gen, (L, cfg.ssm.d_conv, di + 2 * ds), dtype,
                             fan_in=cfg.ssm.d_conv),
        "A_log": torch.zeros((L, H), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((L, H), dtype=torch.float32, device=dev),
        "D": torch.ones((L, H), dtype=torch.float32, device=dev),
        "gate_norm": torch.ones((L, di), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (L, di, d), dtype, fan_in=di),
    }


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_depthwise_conv(x, w):
    """x (B, S, C), w (K, C): causal depthwise conv along S, one tap at a
    time (each product and sum rounds to the promoted dtype)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i : i + x.shape[1]] * w[i]
    return out


def _mamba_gates(p, x, cfg: ModelConfig):
    di, H, ds, _ = _mamba_dims(cfg)
    zxbcdt = mm(x, p["in_proj"])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di : 2 * di + 2 * ds]
    dt_pre = zxbcdt[..., 2 * di + 2 * ds :]
    return z, xbc, dt_pre


def mamba_forward(p, x, cfg: ModelConfig):
    """x (B, S, d) -> (B, S, d), the whole sequence (training / prefill)."""
    B, S, _ = x.shape
    di, H, ds, _ = _mamba_dims(cfg)
    hd = cfg.ssm.head_dim
    z, xbc, dt_pre = _mamba_gates(p, x, cfg)
    xbc = silu(_causal_depthwise_conv(xbc, p["conv_w"]))
    xs = constrain(xbc[..., :di].reshape(B, S, H, hd),
                   ("dp", None, "model", None))
    Bt = xbc[..., di : di + ds]
    Ct = xbc[..., di + ds :]
    dt = softplus(dt_pre.float() + p["dt_bias"])                    # (B,S,H)
    log_f = -dt * torch.exp(p["A_log"])
    k = Bt[:, :, None, :].expand(B, S, H, ds)
    q = Ct[:, :, None, :].expand(B, S, H, ds)
    y, _ = chunked_linear_attention(q, k, v=xs, log_f=log_f, i_gate=dt,
                                    chunk=cfg.ssm.chunk)
    y = y + xs * p["D"][None, None, :, None].to(xs.dtype)
    y = y.reshape(B, S, di)
    y = rmsnorm(p["gate_norm"], y * silu(z))
    return mm(y, p["out_proj"])


def mamba_step(p, x, state, cfg: ModelConfig):
    """Single decode step.  x (B, 1, d); state {ssm (B,H,ds,hd),
    conv (B, K-1, di+2ds)}."""
    B = x.shape[0]
    di, H, ds, K = _mamba_dims(cfg)
    hd = cfg.ssm.head_dim
    z, xbc, dt_pre = _mamba_gates(p, x, cfg)
    # conv ring: the state holds the previous K-1 inputs (torch.cat
    # promotes a bf16 state with f32 inputs, as jnp.concatenate does)
    hist = torch.cat([state["conv"], xbc], dim=1)                # (B, K, C)
    xbc_c = silu(einsum("bkc,kc->bc", hist, p["conv_w"]))[:, None]
    new_conv = hist[:, 1:]
    xs = xbc_c[..., :di].reshape(B, H, hd)
    Bt = xbc_c[:, 0, di : di + ds]
    Ct = xbc_c[:, 0, di + ds :]
    dt = softplus(dt_pre[:, 0].float() + p["dt_bias"])               # (B,H)
    log_f = -dt * torch.exp(p["A_log"])
    k = Bt[:, None, :].expand(B, H, ds)
    q = Ct[:, None, :].expand(B, H, ds)
    y, new_ssm = linear_attention_step(state["ssm"], q, k, xs, log_f, dt)
    y = y + xs * p["D"][None, :, None].to(xs.dtype)
    y = y.reshape(B, 1, di)
    y = rmsnorm(p["gate_norm"], y * silu(z))
    return mm(y, p["out_proj"]), {"ssm": new_ssm, "conv": new_conv}


# ---------------------------------------------------------------------------
# Zamba2 hybrid stack
# ---------------------------------------------------------------------------
def hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, ssm_per_group, trailing_ssm)."""
    k = cfg.ssm.shared_attn_every
    if k <= 0:
        return 0, 0, cfg.n_layers
    g = cfg.n_layers // k
    return g, k, cfg.n_layers - g * k


def init_hybrid(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    g, k, rest = hybrid_layout(cfg)
    dev = gen.device
    p = {
        "mamba": init_mamba(gen, cfg, cfg.n_layers, dtype),
        "norm": torch.ones((cfg.n_layers, cfg.d_model), dtype=dtype,
                           device=dev),
    }
    if g > 0:
        # ONE shared attention + MLP block (Zamba2 weight sharing)
        p["shared_attn"] = tree_map(lambda a: a[0], init_gqa(gen, cfg, 1, dtype))
        p["shared_mlp"] = tree_map(
            lambda a: a[0], init_mlp(gen, cfg.d_model, cfg.d_ff, 1, dtype,
                                     "silu"))
        p["shared_norm1"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
        p["shared_norm2"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    return p
