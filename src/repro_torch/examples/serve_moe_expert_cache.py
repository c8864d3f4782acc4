"""Serve an MoE model with batched requests; the AKPC expert cache observes
routing outcomes, packs co-activated experts into cliques, reports the
transfer-cost saving against per-expert fetching, and gathers a step's
expert cliques from the packed weight table.

    PYTHONPATH=src python -m repro_torch.examples.serve_moe_expert_cache [--device cpu]

The port of ``examples/serve_moe_expert_cache.py``: the same routing tap
(layer 0's router on the served tokens' embeddings), here on the model's
device, feeding an :class:`ExpertCacheManager` on that device; then
``packed_tables`` and a :func:`repro_torch.kernels.packed_lookup` gather
of layer 0's ``wi``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_smoke_config
from ..kernels import packed_lookup
from ..models.api import build_model
from ..serving import BatchedServer, ExpertCacheManager, Request


def make_requests(rng: np.random.Generator, n: int, vocab: int, prompt_lo: int,
                  prompt_hi: int, max_new: int) -> list[Request]:
    """``n`` requests whose prompts have ``prompt_lo`` to ``prompt_hi - 1``
    tokens (the length drawn first, as the reference)."""
    return [Request(rid=rid, prompt=rng.integers(
        0, vocab, size=rng.integers(prompt_lo, prompt_hi)).tolist(),
        max_new=max_new) for rid in range(n)]


def routing_tap(params, cfg, mgr: ExpertCacheManager, host: int = 0,
                record: list | None = None):
    """Layer 0's router top-k of each step's input tokens, fed to ``mgr``
    (and kept in ``record``, one (B, k) array a step, when given)."""
    router0 = params["layers"]["mlp"]["router"][0]          # (d, E) f32
    embed = params["embed"]

    def tap(p, tokens):
        ids = torch.from_numpy(tokens[:, 0]).to(embed.device).long()
        logits = embed[ids].float() @ router0
        # a stable descending sort: the lower expert first on ties
        order = torch.sort(logits, dim=-1, descending=True, stable=True)
        topk = order.indices[:, : cfg.moe.top_k].cpu().numpy()
        if record is not None:
            record.append(topk)
        mgr.observe(topk, host=host)

    return tap


def serve_with_expert_cache(model, params, requests, *, batch_size: int,
                            cache_len: int, n_hosts: int = 2,
                            t_cg: float = 24.0, max_steps: int = 10_000):
    """Serve ``requests`` through a :class:`BatchedServer` whose routing tap
    feeds an AKPC :class:`ExpertCacheManager` on the model's device.
    Returns (server, manager, finished requests, per-step top-k)."""
    cfg = model.cfg
    mgr = ExpertCacheManager(n_experts=cfg.moe.n_experts, n_hosts=n_hosts,
                             t_cg=t_cg, device=model.device)
    topks: list = []
    srv = BatchedServer(model, params, batch_size=batch_size,
                        cache_len=cache_len,
                        routing_tap=routing_tap(params, cfg, mgr, record=topks))
    for r in requests:
        srv.submit(r)
    done = srv.run(max_steps=max_steps)
    return srv, mgr, done, topks


def expert_gather(mgr: ExpertCacheManager, params, topk: np.ndarray) -> dict:
    """Pack layer 0's ``wi`` (one row an expert) clique by clique with
    ``packed_tables`` and gather the cliques of ``topk``'s experts with
    ``packed_lookup`` on the weights' device.  bf16 rows travel through
    numpy as their int16 bit patterns (a byte copy)."""
    wi0 = params["layers"]["mlp"]["wi"][0]                  # (Ep, d, f)
    rows = wi0.reshape(wi0.shape[0], -1)
    bits = rows.view(torch.int16) if rows.dtype == torch.bfloat16 else rows
    table, where = mgr.packed_tables(bits.cpu().numpy())
    ids = np.unique(where[np.unique(topk), 0]).astype(np.int32)
    table_d = torch.from_numpy(table).to(wi0.device)
    if rows.dtype == torch.bfloat16:
        table_d = table_d.view(torch.bfloat16)
    ids_d = torch.from_numpy(ids).to(wi0.device)
    return {"table": table_d, "where": where, "ids": ids_d,
            "rows": packed_lookup(table_d, ids_d)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("granite_moe_3b_a800m")
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    rng = np.random.default_rng(0)
    requests = make_requests(rng, 24, cfg.vocab, 2, 6, 8)
    srv, mgr, done, topks = serve_with_expert_cache(
        model, params, requests, batch_size=4, cache_len=64, max_steps=500)
    print(f"served {len(done)} requests in {srv.steps} decode steps "
          f"on {model.device}")

    stats = mgr.stats()
    print(f"expert-cache: {stats.n_observations} routing observations, "
          f"{len(stats.cliques)} expert cliques: "
          f"{[tuple(map(int, c)) for c in stats.cliques[:6]]}")
    print(f"AKPC packed-expert cost {stats.akpc_total:.1f} vs per-expert "
          f"{stats.nopack_total:.1f}  ->  {stats.saving_pct:.1f}% saved")

    g = expert_gather(mgr, params, topks[-1])
    print(f"packed table: {tuple(g['table'].shape)} (cliques x omega x "
          f"flattened expert); the last step's {g['ids'].numel()} cliques "
          f"gathered: {tuple(g['rows'].shape)}")
    return {"server": srv, "stats": stats, "gather": g}


if __name__ == "__main__":
    main()
