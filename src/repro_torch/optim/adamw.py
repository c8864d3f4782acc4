"""AdamW over dicts of tensors, with the reference's arithmetic.

The port of ``repro.optim.adamw``: f32 moments, global-norm clipping,
decoupled weight decay, a cosine schedule with linear warmup from
``warmup_floor * lr``.  A tree is a nested ``dict`` with ``str`` keys and
tensors at the leaves; leaves are visited in sorted key order at every
level, the order ``jax.tree.flatten`` gives a dict, so the clipping norm
adds the leaves' sums in the reference's order.

The dtypes follow the reference's under x64: each gradient is cast to
f32 before the clip scale, the moments, the schedule and the bias
corrections are f32 (the reference's Python floats are weakly typed), the
new parameter is computed in f32 and cast back to the parameter's dtype,
and weight decay applies only to leaves of two or more dimensions.
Divisors are tensors, never host scalars: CUDA divides a tensor by a
host scalar as a multiply by its reciprocal, which rounds differently.
The f32 ``sqrt``, ``pow`` and ``cos`` are taken in f64 and rounded to f32
(:func:`_rounded`): correctly rounded, so the CPU and the card agree.
torch's f32 ``sqrt`` on the CPU is not, and neither are XLA's f32 ``pow``
and ``cos``: the reference's schedule and bias corrections differ from
these by one f32 ulp at some steps.
Nothing here reads a value back to the host, so a step loop on the card
makes no host sync.

``inplace=True`` writes the new parameters, moments and step into the
tensors passed in and returns those: the caller donates them, as a jitted
step's donated buffers (a full-size model's second copy of the f32 moments
does not fit beside the first on one card).  The values are the same bits.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    #: lr fraction at step 0 of the warmup ramp: warmup runs linearly from
    #: warmup_floor * lr to lr instead of from 0
    warmup_floor: float = 0.0


def tree_leaves(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(path, leaf)`` pairs in sorted key order at every level."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(v, dict):
            out.extend(tree_leaves(v, path))
        else:
            out.append((path, v))
    return out


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``)."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 constant on ``like``'s device (a fill, not a copy)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _rounded(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn`` of f32 tensors, taken in f64 and rounded to f32."""
    return fn(*(a.to(torch.float64) for a in args)).to(torch.float32)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor of any shape), in f32."""
    step = step.to(torch.float32)
    warm = cfg.warmup_floor + (1.0 - cfg.warmup_floor) * (
        step / _f32(max(cfg.warmup_steps, 1), step))
    prog = (step - cfg.warmup_steps) / _f32(
        max(cfg.total_steps - cfg.warmup_steps, 1), step)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + _rounded(torch.cos, math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: dict) -> dict:
    """Zero f32 moments shaped like ``params`` and step 0 (int32)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaf = tree_leaves(params)[0][1]
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the leaves' f32 sums of squares, added in flatten order."""
    total = 0
    for _, x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return _rounded(torch.sqrt, total)


def adamw_update(cfg: AdamWConfig, grads: dict, state: dict, params: dict,
                 inplace: bool = False):
    """Returns ``(new_params, new_state, stats)``; nothing is modified in
    place unless ``inplace``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.minimum(
        _f32(1.0, gnorm),
        _f32(cfg.clip_norm, gnorm) / torch.maximum(gnorm, _f32(1e-9, gnorm)))
    lr = cosine_schedule(cfg, step)
    step32 = step.to(torch.float32)
    bc1 = 1.0 - _rounded(torch.pow, _f32(cfg.b1, step32), step32)
    bc2 = 1.0 - _rounded(torch.pow, _f32(cfg.b2, step32), step32)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (_rounded(torch.sqrt, vhat) + cfg.eps)
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0   # no decay on biases
        p_new = p.to(torch.float32) * (1.0 - lr * wd) - lr * delta
        return donate((p, m, v), (p_new.to(p.dtype), m_new, v_new), inplace)

    out = tree_map(upd, grads, state["m"], state["v"], params)

    def part(i):
        return tree_map(lambda o: o[i], out)

    (step,) = donate((state["step"],), (step,), inplace)
    return part(0), {"m": part(1), "v": part(2), "step": step}, {
        "grad_norm": gnorm, "lr": lr,
    }


def donate(old: tuple, new: tuple, inplace: bool) -> tuple:
    """``new``, or with ``inplace`` ``new`` copied into ``old``'s tensors."""
    if not inplace:
        return new
    return tuple(o.copy_(n) for o, n in zip(old, new))
