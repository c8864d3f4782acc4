"""8-bit AdamW: blockwise-quantised moments (port of ``repro.optim.adamw8bit``).

``m`` is stored as symmetric int8 with a per-block (128 elements along the
last axis) f32 absmax scale; ``v`` stores ``sqrt(v)`` in the same layout
(linear int8 on the sqrt domain covers v's range quadratically).  The
moments dequantise -> update -> requantise inside the step, so the
resident state is two int8 codes and two scales a block instead of two f32
moments: about a quarter.

The arithmetic is :mod:`.adamw`'s (clip scale, cosine schedule, the bias
corrections, decoupled weight decay on leaves of two or more dimensions)
with the reference's quantiser: ``scale = max|block| / 127`` in f32,
``round`` half to even of ``x / max(scale, 1e-20)``, clipped to +-127.
Divisors are device tensors, and the f32 ``sqrt`` and ``pow`` are taken
in f64 and rounded (:func:`.adamw._rounded`), so the card and the CPU give
the same codes.  The update DONATES its arguments, as
:func:`.adamw.adamw_update` does with ``inplace``: the new parameters,
codes, scales and step are written into the tensors given (its one
caller, the train step, donates them).  A caller that needs the old
state clones it first.
"""
from __future__ import annotations

import torch

from .adamw import (
    AdamWConfig,
    _f32,
    _rounded,
    cosine_schedule,
    donate,
    global_norm,
    tree_leaves,
    tree_map,
)

BLOCK = 128


def _nblocks(n: int) -> int:
    return -(-n // BLOCK)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., nblocks, BLOCK), zero-padded at the end."""
    n = x.shape[-1]
    pad = _nblocks(n) * BLOCK - n
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    return x.reshape(x.shape[:-1] + (-1, BLOCK))


def _unblocks(xb: torch.Tensor, shape) -> torch.Tensor:
    return xb.reshape(tuple(shape[:-1]) + (-1,))[..., : shape[-1]]


def quantise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 codes shaped like ``x``, f32 scales (..., nblocks))."""
    xb = _blocks(x.to(torch.float32))
    scale = torch.amax(torch.abs(xb), dim=-1) / _f32(127.0, x)
    q = torch.round(xb / torch.maximum(scale[..., None], _f32(1e-20, x)))
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return _unblocks(q, x.shape).contiguous(), scale


def dequantise(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return _unblocks(_blocks(q.to(torch.float32)) * scale[..., None], shape)


def adamw8bit_init(params: dict) -> dict:
    """Zero codes and scales a leaf of ``params`` and step 0 (int32)."""
    def one(p):
        nb = _nblocks(p.shape[-1]) if p.ndim else 1
        dev = p.device

        def codes():
            return torch.zeros(p.shape, dtype=torch.int8, device=dev)

        def scales():
            return torch.zeros(p.shape[:-1] + (nb,), dtype=torch.float32,
                               device=dev)

        return {"m_q": codes(), "m_s": scales(), "v_q": codes(),
                "v_s": scales()}

    leaf = tree_leaves(params)[0][1]
    return {"mv": tree_map(one, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def adamw8bit_update(cfg: AdamWConfig, grads: dict, state: dict,
                     params: dict):
    """Returns ``(new_params, new_state, stats)``: ``params`` and ``state``,
    their tensors overwritten."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.minimum(
        _f32(1.0, gnorm),
        _f32(cfg.clip_norm, gnorm) / torch.maximum(gnorm, _f32(1e-9, gnorm)))
    lr = cosine_schedule(cfg, step)
    step32 = step.to(torch.float32)
    bc1 = 1.0 - _rounded(torch.pow, _f32(cfg.b1, step32), step32)
    bc2 = 1.0 - _rounded(torch.pow, _f32(cfg.b2, step32), step32)

    def upd(g, mv, p):
        g = g.to(torch.float32) * scale
        m = dequantise(mv["m_q"], mv["m_s"], p.shape)
        v = torch.square(dequantise(mv["v_q"], mv["v_s"], p.shape))
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        delta = (m / bc1) / (_rounded(torch.sqrt, v / bc2) + cfg.eps)
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        p_new = (p.to(torch.float32) * (1.0 - lr * wd) - lr * delta).to(
            p.dtype)
        m_q, m_s = quantise(m)
        v_q, v_s = quantise(_rounded(torch.sqrt, v))
        names = ("m_q", "m_s", "v_q", "v_s")
        out = donate((p,) + tuple(mv[k] for k in names),
                     (p_new, m_q, m_s, v_q, v_s), True)
        return out[0], dict(zip(names, out[1:]))

    out = tree_map(upd, grads, state["mv"], params)
    new_p = tree_map(lambda o: o[0], out)
    new_mv = tree_map(lambda o: o[1], out)
    (step,) = donate((state["step"],), (step,), True)
    return new_p, {"mv": new_mv, "step": step}, {"grad_norm": gnorm, "lr": lr}
