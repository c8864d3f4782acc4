"""xLSTM blocks: the mLSTM (matrix memory, parallel) and the sLSTM (scalar
memory, sequential); the port of ``repro.models.xlstm``.

mLSTM: pre-norm, an up-projection (factor 2) split into an x branch and a
z gate; q/k/v heads over the inner dim; sigmoid forget and input gates
(taken in f32) through the chunked linear attention WITH a normaliser
state (an extra all-ones value column); ``h = num / max(|den|, 1)``, gated
by SiLU(z), down-projected.

sLSTM: scalar cell and normaliser states (f32) a feature with recurrent
gate connections, sequential over time (a Python loop: the reference's
``lax.scan``); then a small GELU FFN (projection factor 4/3).

Block pattern: ``mlstm_per_group`` mLSTM blocks then 1 sLSTM block,
repeated (12 layers = 3 x (3 mLSTM + 1 sLSTM) for xlstm-125m).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import clip, dense_init, gelu, mm, rmsnorm, silu
from .config import ModelConfig
from .linear_attn import chunked_linear_attention, linear_attention_step
from .shard_ctx import constrain


def _mlstm_dims(cfg: ModelConfig):
    di = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
    H = cfg.n_heads
    hd = di // H
    return di, H, hd


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, L: int, dtype) -> dict:
    d = cfg.d_model
    di, H, hd = _mlstm_dims(cfg)
    dev = gen.device
    return {
        "norm": torch.ones((L, d), dtype=dtype, device=dev),
        "up": dense_init(gen, (L, d, 2 * di), dtype, fan_in=d),
        "wq": dense_init(gen, (L, di, di), dtype, fan_in=di),
        "wk": dense_init(gen, (L, di, di), dtype, fan_in=di),
        "wv": dense_init(gen, (L, di, di), dtype, fan_in=di),
        "w_if": dense_init(gen, (L, di, 2 * H), dtype, fan_in=di),
        "out_norm": torch.ones((L, di), dtype=dtype, device=dev),
        "down": dense_init(gen, (L, di, d), dtype, fan_in=di),
    }


def _mlstm_qkvg(p, x, cfg):
    B, S, _ = x.shape
    di, H, hd = _mlstm_dims(cfg)
    u = mm(rmsnorm(p["norm"], x), p["up"])
    xb, z = u[..., :di], u[..., di:]
    q = constrain(mm(xb, p["wq"]).reshape(B, S, H, hd) * hd ** -0.5,
                  ("dp", None, "model", None))
    k = constrain(mm(xb, p["wk"]).reshape(B, S, H, hd) * hd ** -0.5,
                  ("dp", None, "model", None))
    v = constrain(mm(xb, p["wv"]).reshape(B, S, H, hd),
                  ("dp", None, "model", None))
    g = mm(xb, p["w_if"]).float()
    i_gate = torch.sigmoid(g[..., :H])
    log_f = F.logsigmoid(g[..., H:])
    return q, k, v, i_gate, log_f, z


def _mlstm_out(p, num_den, z, cfg):
    di, H, hd = _mlstm_dims(cfg)
    num, den = num_den[..., :hd], num_den[..., hd:]
    h = num / clip(torch.abs(den), 1.0)
    B = h.shape[0]
    h = h.reshape(B, -1, di)
    h = rmsnorm(p["out_norm"], h) * silu(z)
    return mm(h, p["down"])


def mlstm_forward(p, x, cfg: ModelConfig):
    q, k, v, i_gate, log_f, z = _mlstm_qkvg(p, x, cfg)
    v_aug = torch.cat([v, torch.ones_like(v)], dim=-1)      # normaliser col
    y, _ = chunked_linear_attention(q, k, v_aug, log_f, i_gate,
                                    chunk=cfg.xlstm.chunk)
    return x + _mlstm_out(p, y, z, cfg)


def mlstm_step(p, x, state, cfg: ModelConfig):
    """x (B,1,d); state (B,H,hd,2*hd)."""
    q, k, v, i_gate, log_f, z = _mlstm_qkvg(p, x, cfg)
    v_aug = torch.cat([v, torch.ones_like(v)], dim=-1)
    y, new_state = linear_attention_step(
        state, q[:, 0], k[:, 0], v_aug[:, 0], log_f[:, 0], i_gate[:, 0])
    return x + _mlstm_out(p, y[:, None], z, cfg), new_state


def init_slstm(gen: torch.Generator, cfg: ModelConfig, L: int, dtype) -> dict:
    d = cfg.d_model
    dff = int(d * cfg.xlstm.proj_factor_slstm)
    dev = gen.device
    return {
        "norm": torch.ones((L, d), dtype=dtype, device=dev),
        "wx": dense_init(gen, (L, d, 4 * d), dtype, fan_in=d),
        "wr": dense_init(gen, (L, d, 4 * d), dtype, fan_in=d),
        "ffn_norm": torch.ones((L, d), dtype=dtype, device=dev),
        "ffn_wi": dense_init(gen, (L, d, dff), dtype, fan_in=d),
        "ffn_wo": dense_init(gen, (L, dff, d), dtype, fan_in=dff),
    }


def _slstm_cell(p, xt, carry):
    """xt (B, 4d) pre-activations from the input; carry (h, c, n): ``c``
    and ``n`` f32, the new ``h`` in ``h``'s dtype."""
    h, c, n = carry
    d = h.shape[-1]
    g = (xt + mm(h, p["wr"])).float()
    z = torch.tanh(g[..., :d])
    i = torch.sigmoid(g[..., d : 2 * d])
    f = torch.sigmoid(g[..., 2 * d : 3 * d])
    o = torch.sigmoid(g[..., 3 * d :])
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = (o * c_new / clip(n_new, 1.0)).to(h.dtype)
    return h_new, c_new, n_new


def slstm_forward(p, x, cfg: ModelConfig):
    B, S, d = x.shape
    xs = mm(rmsnorm(p["norm"], x), p["wx"])              # (B, S, 4d)
    carry = (torch.zeros((B, d), dtype=x.dtype, device=x.device),
             torch.zeros((B, d), dtype=torch.float32, device=x.device),
             torch.zeros((B, d), dtype=torch.float32, device=x.device))
    hs = []
    for t in range(S):
        carry = _slstm_cell(p, xs[:, t], carry)
        hs.append(carry[0])
    y = x + torch.stack(hs, dim=1)
    h = gelu(mm(rmsnorm(p["ffn_norm"], y), p["ffn_wi"]))
    return y + mm(h, p["ffn_wo"])


def slstm_step(p, x, state, cfg: ModelConfig):
    """x (B,1,d); state (h, c, n) each (B, d)."""
    xt = mm(rmsnorm(p["norm"], x), p["wx"])[:, 0]
    h, c, n = _slstm_cell(p, xt, state)
    y = x + h[:, None]
    hh = gelu(mm(rmsnorm(p["ffn_norm"], y), p["ffn_wi"]))
    return y + mm(hh, p["ffn_wo"]), (h, c, n)


def xlstm_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, mlstm_per_group); layers = groups * (m + 1)."""
    m = cfg.xlstm.mlstm_per_group
    g = cfg.n_layers // (m + 1)
    if g * (m + 1) != cfg.n_layers:
        raise AssertionError("n_layers must divide the block pattern")
    return g, m
