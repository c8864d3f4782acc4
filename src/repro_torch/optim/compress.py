"""Gradient compression with error feedback (port of ``repro.optim.compress``).

A per-tensor int8 quantiser with an ERROR-FEEDBACK accumulator: the
quantisation residual is added back to the next step's gradient, so the
compressed optimizer converges like the uncompressed one.  The train step
quantises the accumulated gradient and dequantises it before the update
(``launch/train.py``, ``compress=True``).

The reference's arithmetic: ``x = g + e`` in f32, ``scale = max(max|x|,
1e-12) / 127`` in f32, ``q = clip(round(x / scale), -127, 127)`` as int8
(``torch.round`` rounds half to even, as ``jnp.round``), the residual
``x - q * scale``.  Divisors are device tensors: CUDA divides a tensor by
a host scalar as a multiply by its reciprocal.  Both functions write
their results into tensors they are given, leaf by leaf: the new
residuals into ``ef_state``'s, the dequantised gradients into ``like``'s
(the train step donates both; a full-size model's f32 trees do not fit
twice beside its moments).  A caller that needs the old values clones
them first.
"""
from __future__ import annotations

import torch

from .adamw import _f32, tree_map


def ef_init(params: dict) -> dict:
    """Zero f32 residuals shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.maximum(torch.max(torch.abs(x)), _f32(1e-12, x)) / _f32(
        127.0, x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_gradients(grads: dict, ef_state: dict) -> tuple[dict, dict]:
    """``(qtree, new_ef)``: ``qtree`` has an ``(int8 codes, f32 scale)``
    pair at each leaf of ``grads``; ``new_ef`` is ``ef_state``, its
    tensors overwritten with the new residuals."""
    def one(g, e):
        gf = g.to(torch.float32) + e
        q, s = _quantise(gf)
        err = gf - _dequantise(q, s)
        return (q, s), e.copy_(err)

    out = tree_map(one, grads, ef_state)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def decompress_gradients(qtree: dict, like: dict) -> dict:
    """The dequantised gradients, each in ``like``'s leaf's dtype: ``like``,
    its tensors overwritten."""
    def one(l, qs):
        return l.copy_(_dequantise(*qs).to(l.dtype))

    return tree_map(one, like, qtree)
