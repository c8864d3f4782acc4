"""MLPs and Mixture-of-Experts (port of ``repro.models.mlp``).

MoE: token-choice top-k routing with a static per-expert CAPACITY
(``max(8, int(T * k * capacity_factor / E))``); overflow assignments are
dropped in flattened (token, k) order.  The dispatch is the reference's
static-shaped one: assignment ranks from a one-hot cumulative count, token
gathers from an (E, C) slot table, batched expert products over every
(padded) expert.  The expert-parallel ``shard_map`` branches of
``moe_forward`` wait for the production mesh (ROADMAP, queue 1, item 6);
under a mesh it raises.
"""
from __future__ import annotations

import torch

from .common import act_fn, dense_init, einsum, mm, silu
from .config import ModelConfig


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d: int, d_ff: int, L: int, dtype,
             activation: str) -> dict:
    p = {
        "wi": dense_init(gen, (L, d, d_ff), dtype, fan_in=d),
        "wo": dense_init(gen, (L, d_ff, d), dtype, fan_in=d_ff),
    }
    if activation == "silu":                      # SwiGLU gate
        p["wg"] = dense_init(gen, (L, d, d_ff), dtype, fan_in=d)
    return p


def mlp_forward(p, x, activation: str):
    h = act_fn(activation)(mm(x, p["wi"]))
    if "wg" in p:
        h = h * mm(x, p["wg"])
    return mm(h, p["wo"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def init_moe(gen: torch.Generator, cfg: ModelConfig, L: int, dtype) -> dict:
    mo = cfg.moe
    d = cfg.d_model
    Ep = mo.n_experts_padded        # the router never emits a padded expert
    p = {
        "router": dense_init(gen, (L, d, mo.n_experts), torch.float32, fan_in=d),
        "wi": dense_init(gen, (L, Ep, d, mo.d_ff_expert), dtype, fan_in=d),
        "wg": dense_init(gen, (L, Ep, d, mo.d_ff_expert), dtype, fan_in=d),
        "wo": dense_init(gen, (L, Ep, mo.d_ff_expert, d), dtype,
                         fan_in=mo.d_ff_expert),
    }
    if mo.n_shared > 0:
        p["shared"] = init_mlp(gen, d, mo.n_shared * mo.d_ff_expert, L, dtype,
                               "silu")
    return p


def _routed_local(x_flat, topk_idx, topk_w, wi, wg, wo, *, n_experts: int,
                  n_shards: int, shard_id: int, capacity: int):
    """Routed-expert output of the LOCAL expert slice.

    x_flat (T, d); topk_idx/topk_w (T, k); wi/wg/wo (E_local, ...).
    Returns (T, d) with ONLY the local experts' contributions.
    """
    T, d = x_flat.shape
    k = topk_idx.shape[1]
    dev = x_flat.device
    e_local = n_experts // n_shards
    e0 = shard_id * e_local
    a_eid = topk_idx.reshape(-1)                       # (A,) A = T*k
    # (no repeat_interleave: on CUDA it reads its output size back)
    a_tok = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(-1)
    a_w = topk_w.reshape(-1)
    local = (a_eid >= e0) & (a_eid < e0 + e_local)
    eid_l = torch.where(local, a_eid - e0, e_local)    # e_local = trash
    oh = eid_l[:, None] == torch.arange(e_local, device=dev)[None, :]
    # an assignment's rank is its cumulative count in flattened (token, k)
    # order: overflow past the capacity is dropped in that order
    rank = torch.cumsum(oh.long(), dim=0) - 1          # (A, E_l)
    a_rank = (rank * oh).sum(-1)
    keep = local & (a_rank < capacity)
    slot_e = torch.where(keep, eid_l, e_local)         # drop via the trash row
    slot_c = torch.where(keep, a_rank, 0)
    flat = slot_e * capacity + slot_c                  # kept slots are unique
    n_slots = (e_local + 1) * capacity
    tok_tab = torch.full((n_slots,), T, dtype=torch.long, device=dev)
    tok_tab = tok_tab.scatter(0, flat, a_tok).view(e_local + 1, capacity)
    w_tab = torch.zeros((n_slots,), dtype=x_flat.dtype, device=dev)
    w_tab = w_tab.scatter(0, flat, a_w.to(x_flat.dtype)).view(e_local + 1, capacity)
    tok_tab, w_tab = tok_tab[:e_local], w_tab[:e_local]
    valid = tok_tab < T
    xe = torch.where(valid[..., None], x_flat[torch.clamp(tok_tab, 0, T - 1)],
                     0.0)                              # (E_l, C, d)
    h = silu(einsum("ecd,edf->ecf", xe, wi))
    h = h * einsum("ecd,edf->ecf", xe, wg)
    ye = einsum("ecf,efd->ecd", h, wo) * w_tab[..., None]
    # f32 combine.  The reference scatter-adds in slot order, i.e. each
    # token's contributions by ascending expert; an atomic index_add_ on
    # CUDA would add them in an order that changes from run to run.  So
    # each assignment gathers its slot's row (dropped ones a zero row),
    # and a token's k rows are summed one by one in ascending expert order.
    rows = torch.cat([ye.reshape(-1, d).float(),
                      torch.zeros((1, d), dtype=torch.float32, device=dev)])
    contrib = rows[torch.where(keep, flat, e_local * capacity)].view(T, k, d)
    order = torch.argsort(topk_idx, dim=1, stable=True)
    contrib = torch.take_along_dim(contrib, order[..., None], dim=1)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out.to(x_flat.dtype)


def route(p, x_flat, cfg: ModelConfig):
    """Router top-k of (T, d) tokens: (probs, topk_w, topk_idx).

    Dtype promotion: ``x_flat @ router`` is bf16 @ f32, which JAX
    promotes to f32 and torch refuses, so the tokens are cast first.
    Top-k ties: ``jax.lax.top_k`` puts the lower index first; ``torch.topk``
    promises no order, so a stable descending sort takes its place."""
    logits = mm(x_flat.float(), p["router"]).float()         # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    topk_w, topk_idx = w[:, :k], idx[:, :k]
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    return probs, topk_w, topk_idx


def moe_forward(p, x, cfg: ModelConfig, mesh=None):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar)."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_forward's expert-parallel shard_map branches need the "
            "production mesh (ROADMAP, queue 1, item 6: the production mesh)")
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    x_flat = x.reshape(T, d)
    probs, topk_w, topk_idx = route(p, x_flat, cfg)
    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(0)
    # a one-hot count (torch.bincount on CUDA reads its size back)
    ce = (topk_idx.reshape(-1, 1) == torch.arange(
        mo.n_experts, device=x.device)).sum(0).float()
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    aux = mo.aux_loss_coef * mo.n_experts * torch.sum(me * ce)

    capacity = max(8, int(T * mo.top_k * mo.capacity_factor / mo.n_experts))
    y = _routed_local(
        x_flat, topk_idx, topk_w, p["wi"], p["wg"], p["wo"],
        n_experts=mo.n_experts_padded, n_shards=1, shard_id=0,
        capacity=capacity,
    )
    if mo.n_shared > 0:
        y = y + mlp_forward(p["shared"], x_flat, "silu")
    return y.reshape(B, S, d), aux
