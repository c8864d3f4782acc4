"""MLPs and Mixture-of-Experts (port of ``repro.models.mlp``).

MoE: token-choice top-k routing with a static per-expert CAPACITY
(``max(8, int(T * k * capacity_factor / E))``); overflow assignments are
dropped in flattened (token, k) order.  The dispatch is the reference's
static-shaped one: assignment ranks from a one-hot cumulative count, token
gathers from an (E, C) slot table, batched expert products over every
(padded) expert.

Under a mesh with a ``model`` axis, ``moe_forward`` runs the reference's
expert-parallel ``shard_map`` branches shard by shard: the weight-
stationary decode branch over (model, data) shards, the token-sharded
branch over data shards x model shards.  Each shard's partial is the
reference's per-shard ``_routed_local`` (its capacity, so its token drops;
its f32 combine, rounded to the activation dtype), and the partials sum in
f32 in a fixed order, as the reference's ``psum``.  :func:`_routed`
computes the grid of shards at once, on the tokens' device: a loop of
``_routed_local`` calls, one a shard, issues 256 x ~130 ops a layer on the
production mesh, which the dry run's meta trace cannot afford.
"""
from __future__ import annotations

import torch

from .common import act_fn, clip, dense_init, einsum, mm, silu
from .config import ModelConfig
from .shard_ctx import record_collective


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


def _routed(x, topk_idx, topk_w, wi, wg, wo, *, e0: int, capacity: int,
            model_shards: int = 1, ff_shards: int = 1):
    """Every shard's routed-expert partial at once: the reference's
    per-shard ``_routed_local`` over a grid of shards.

    x (G, t, d): G token groups (data shards), each routed on its own with
    per-expert ``capacity``; topk_idx / topk_w (G, t, k); wi / wg (E, d,
    ff), wo (E, ff, d): experts ``e0`` .. ``e0 + E - 1``, split into
    ``model_shards`` blocks of experts and ``ff_shards`` blocks of ff.
    Returns (model_shards, G, ff_shards, t, d) in x's dtype: shard (i, j)'s
    contributions (experts block i through ff block j), each token's summed
    in f32 in ascending expert order and then rounded.
    """
    G, t, d = x.shape
    k = topk_idx.shape[-1]
    dev = x.device
    e_local = wi.shape[0]
    a_eid = topk_idx.reshape(G, -1)                    # (G, A) A = t*k
    # (no repeat_interleave: on CUDA it reads its output size back)
    a_tok = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(1, -1)
    a_w = topk_w.reshape(G, -1)
    local = (a_eid >= e0) & (a_eid < e0 + e_local)
    eid_l = torch.where(local, a_eid - e0, e_local)    # e_local = trash
    oh = eid_l[..., None] == torch.arange(e_local, device=dev)
    # an assignment's rank is its cumulative count in flattened (token, k)
    # order: overflow past the capacity is dropped in that order
    rank = torch.cumsum(oh.long(), dim=1) - 1          # (G, A, E)
    a_rank = (rank * oh).sum(-1)
    keep = local & (a_rank < capacity)
    slot_e = torch.where(keep, eid_l, e_local)         # drop via the trash row
    slot_c = torch.where(keep, a_rank, 0)
    flat = slot_e * capacity + slot_c                  # kept slots are unique
    n_slots = (e_local + 1) * capacity
    tok_tab = torch.full((G, n_slots), t, dtype=torch.long, device=dev)
    tok_tab = tok_tab.scatter(1, flat, a_tok.expand(G, -1)).view(
        G, e_local + 1, capacity)[:, :e_local]
    w_tab = torch.zeros((G, n_slots), dtype=x.dtype, device=dev)
    w_tab = w_tab.scatter(1, flat, a_w.to(x.dtype)).view(
        G, e_local + 1, capacity)[:, :e_local]
    valid = tok_tab < t
    grp = torch.arange(G, device=dev)[:, None, None]
    xe = torch.where(valid[..., None], x[grp, torch.clamp(tok_tab, 0, t - 1)],
                     0.0)                              # (G, E, C, d)
    h = silu(einsum("gecd,edf->gecf", xe, wi))
    h = h * einsum("gecd,edf->gecf", xe, wg)
    J = ff_shards
    f_l = h.shape[-1] // J
    ye = einsum("gecjf,ejfd->gjecd", h.reshape(G, e_local, capacity, J, f_l),
                wo.reshape(e_local, J, f_l, d)) * w_tab[:, None, ..., None]
    # f32 combine.  The reference scatter-adds in slot order, i.e. each
    # token's contributions by ascending expert; an atomic index_add_ on
    # CUDA would add them in an order that changes from run to run.  So
    # each assignment gathers its slot's row (dropped ones a zero row),
    # and a token's k rows are summed one by one in ascending expert order.
    rows = torch.cat([ye.reshape(G, J, -1, d).float(),
                      torch.zeros((G, J, 1, d), dtype=torch.float32,
                                  device=dev)], dim=2)
    slot = torch.where(keep, flat, e_local * capacity)
    contrib = torch.gather(rows, 2, slot[:, None, :, None].expand(
        G, J, t * k, d)).view(G, J, t, k, d)
    order = torch.argsort(topk_idx, dim=-1, stable=True)     # (G, t, k)
    contrib = torch.take_along_dim(contrib, order[:, None, :, :, None], dim=3)
    if model_shards > 1:
        # the model shard owning each sorted assignment (non-local ones
        # have zero rows): shard i sums only its own
        owner = (torch.take_along_dim(topk_idx, order, dim=-1) - e0) // (
            e_local // model_shards)
        shard = torch.arange(model_shards, device=dev).view(-1, 1, 1, 1, 1)
        owns = owner[None, :, None, :, :, None] == shard[..., None]
        contrib = torch.where(owns, contrib[None], 0.0)
    else:
        contrib = contrib[None]                        # (M, G, J, t, k, d)
    out = contrib[..., 0, :]
    for j in range(1, k):
        out = out + contrib[..., j, :]
    return out.to(x.dtype)


def _routed_local(x_flat, topk_idx, topk_w, wi, wg, wo, *, n_experts: int,
                  n_shards: int, shard_id: int, capacity: int):
    """Routed-expert output of the LOCAL expert slice.

    x_flat (T, d); topk_idx/topk_w (T, k); wi/wg/wo (E_local, ...).
    Returns (T, d) with ONLY the local experts' contributions.
    """
    return _routed(x_flat[None], topk_idx[None], topk_w[None], wi, wg, wo,
                   e0=shard_id * (n_experts // n_shards),
                   capacity=capacity)[0, 0, 0]


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
    topk_w = topk_w / clip(topk_w.sum(-1, keepdim=True), 1e-9)
    return probs, topk_w, topk_idx


def moe_forward(p, x, cfg: ModelConfig, mesh=None):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar)."""
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

    n_shards = mesh.shape["model"] if mesh is not None else 1
    dsz = mesh.shape.get("data", 1) if mesh is not None else 1
    ws_ok = (
        mesh is not None and n_shards > 1 and T <= 1024
        and "data" in mesh.axis_names
        and mo.d_ff_expert % dsz == 0
    )
    if mesh is None or n_shards == 1:
        capacity = max(8, int(T * mo.top_k * mo.capacity_factor / mo.n_experts))
        y = _routed_local(
            x_flat, topk_idx, topk_w, p["wi"], p["wg"], p["wo"],
            n_experts=mo.n_experts_padded, n_shards=1, shard_id=0,
            capacity=capacity,
        )
    elif ws_ok:
        # WEIGHT-STATIONARY decode branch: every token on every shard,
        # experts over `model`, ff over `data`; the (T, d) partials sum
        # over both axes (one all-reduce, no expert-weight gathers)
        record_collective("all-reduce", T * d * 4, n_shards * dsz,
                          "moe_weight_stationary")
        capacity = max(8, int(T * mo.top_k * mo.capacity_factor / mo.n_experts))
        parts = _routed(x_flat[None], topk_idx[None], topk_w[None], p["wi"],
                        p["wg"], p["wo"], e0=0, capacity=capacity,
                        model_shards=n_shards, ff_shards=dsz)
        y = parts.float().sum(dim=(0, 2))[0].to(x.dtype)
    else:
        # TOKEN-SHARDED branch: tokens split over the DP shards (all of
        # them on every shard when T does not divide: tiny-batch decode),
        # experts over `model`; each data shard's partials sum over model
        dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        dp_n = 1
        for a in dp:
            dp_n *= mesh.shape[a]
        groups = dp_n if T % dp_n == 0 else 1
        t_l = T // groups
        record_collective("all-reduce", t_l * d * 4, n_shards,
                          "moe_token_sharded")
        capacity = max(8, int(t_l * mo.top_k * mo.capacity_factor
                              / mo.n_experts))
        parts = _routed(x_flat.view(groups, t_l, d),
                        topk_idx.view(groups, t_l, -1),
                        topk_w.view(groups, t_l, -1), p["wi"], p["wg"],
                        p["wo"], e0=0, capacity=capacity,
                        model_shards=n_shards)
        y = parts.float().sum(dim=0)[:, 0].reshape(T, d).to(x.dtype)
    if mo.n_shared > 0:
        y = y + mlp_forward(p["shared"], x_flat, "silu")
    return y.reshape(B, S, d), aux
