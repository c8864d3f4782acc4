"""Chunked linear attention / SSD (port of ``repro.models.linear_attn``).

Shared by Mamba-2 and the mLSTM.  Recurrent semantics, per head:

    S_t = exp(log_f_t) * S_{t-1} + i_t * k_t v_t^T        (state: dk x dv)
    y_t = q_t . S_t

Prefill runs the chunkwise form: within a chunk of length C a masked
(C, C) product, across chunks a (dk, dv) f32 state carried by a Python
loop over the chunks (the reference's ``lax.scan``).  ``log_f <= 0``
always, so every ``exp`` argument is ``<= 0``.

Order and dtypes are the reference's: intra-chunk scores are taken in f32,
decayed by ``exp(clip(A_c - A_j, -80, 0))`` and masked to the lower
triangle after the product, then cast to ``v``'s dtype before the value
product; ``y`` returns in ``v``'s dtype.  ``jnp.cumsum`` and
``torch.cumsum`` may sum in other orders, so f32 results meet the
reference at a tolerance, not bit for bit.
"""
from __future__ import annotations

import torch

from .common import clip, einsum
from .shard_ctx import constrain


def chunked_linear_attention(q, k, v, log_f, i_gate, *, chunk: int,
                             initial_state=None):
    """q/k (B,S,H,dk), v (B,S,H,dv), log_f/i_gate (B,S,H).

    Returns (y (B,S,H,dv) in ``v``'s dtype, final_state (B,H,dk,dv) f32).
    """
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if S % chunk:
        raise AssertionError((S, chunk))
    n = S // chunk
    qc = q.reshape(B, n, chunk, H, dk).transpose(0, 1)
    kc = k.reshape(B, n, chunk, H, dk).transpose(0, 1)
    vc = v.reshape(B, n, chunk, H, dv).transpose(0, 1)
    ac = log_f.reshape(B, n, chunk, H).transpose(0, 1).float()
    ic = i_gate.reshape(B, n, chunk, H).transpose(0, 1).float()

    if initial_state is None:
        state = constrain(torch.zeros((B, H, dk, dv), dtype=torch.float32,
                                      device=q.device),
                          ("dp", "model", None, None))
    else:
        state = initial_state.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    ys = []
    for c in range(n):
        qb, kb, vb, ab, ib = qc[c], kc[c], vc[c], ac[c], ic[c]
        A = torch.cumsum(ab, dim=1)                  # inclusive log-decay
        A_last = A[:, -1]                            # (B,H)
        # inter-chunk: y_t += exp(A_t) q_t . S_prev
        y_inter = einsum("bchd,bhdv->bchv", qb * torch.exp(A)[..., None],
                         state)
        # intra-chunk: masked decayed attention
        s = einsum("bchd,bjhd->bhcj", qb, kb).float()
        s = constrain(s, ("dp", "model", None, None))
        dec = torch.exp(clip(A[:, :, None, :] - A[:, None, :, :],
                               -80.0, 0.0)).permute(0, 3, 1, 2)
        ig = ib.transpose(1, 2)[:, :, None, :]       # (B,H,1,C) i_j a column
        s = s * dec * ig
        s = torch.where(tri[None, None], s, 0.0)
        y_intra = einsum("bhcj,bjhv->bchv", s.to(vb.dtype), vb)
        # state update
        wk = ib * torch.exp(clip(A_last[:, None, :] - A, -80.0, 0.0))
        state = state * torch.exp(A_last)[..., None, None] + einsum(
            "bjhd,bjhv->bhdv", (kb * wk[..., None]).float(), vb.float())
        state = constrain(state, ("dp", "model", None, None))
        ys.append(y_inter.float() + y_intra.float())
    y = torch.stack(ys).transpose(0, 1).reshape(B, S, H, dv)
    return y.to(v.dtype), state


def linear_attention_step(state, q, k, v, log_f, i_gate):
    """Single decode step.  state (B,H,dk,dv); q/k (B,H,dk); v (B,H,dv);
    log_f/i_gate (B,H).  Returns (y (B,H,dv) in ``v``'s dtype, new
    state)."""
    f = torch.exp(log_f.float())[..., None, None]
    outer = torch.einsum("bhd,bhv->bhdv", k.float(), v.float())
    new = state * f + i_gate.float()[..., None, None] * outer
    y = einsum("bhd,bhdv->bhv", q.float(), new)
    return y.to(v.dtype), new
