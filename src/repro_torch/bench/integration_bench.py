"""The framework integrations on the port: the AKPC shard-prefetch cache
of the input pipeline and the MoE expert cache.

    python -m repro_torch.bench.integration_bench [--backend live]
                                                 [--device cpu]

The port of ``benchmarks/integration_bench.py``: a
:class:`~repro_torch.data.PackedDataPipeline` over a 256-shard
:class:`~repro_torch.data.ShardStore` draws 150 batches of 16 x 256
tokens, and an :class:`~repro_torch.serving.ExpertCacheManager` (64
experts, 4 hosts) observes 1,200 steps of co-activated experts from a
Zipf-weighted choice of 8 expert groups; each reports its AKPC cost (the
expert cache also its per-expert cost and saving).  Both caches replay on
``--device`` (default CUDA) through ``--backend`` (``session``, the
default, or ``live``).  The payload lands in
``integration_bench_torch.json`` under ``REPRO_RESULTS``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..data import PackedDataPipeline, ShardStore
from ..serving import ExpertCacheManager
from .common import device_arg, emit, save_json


def run(backend: str = "session", device=None) -> tuple[dict, list]:
    """The payload and the CSV rows."""
    rows, payload = [], {}
    store = ShardStore(n_shards=256, shard_tokens=1024, vocab=1024,
                       n_domains=8)
    pipe = PackedDataPipeline(store, batch_rows=16, seq_len=256,
                              backend=backend, device=device)
    for _ in range(150):
        next(pipe)
    tl = pipe.telemetry
    drain = getattr(pipe.cache, "drain", None)
    if drain is not None:               # the live engine settles its totals
        drain()
        tl.akpc_total = pipe.cache.costs.total
    rows.append(("integration/data_pipeline", 0,
                 f"batches={tl.batches};shard_requests={tl.shards_fetched};"
                 f"akpc_cost={round(tl.akpc_total, 1)}"))
    payload["pipeline"] = {"akpc": tl.akpc_total, "fetches": tl.shards_fetched}

    rng = np.random.default_rng(0)
    mgr = ExpertCacheManager(n_experts=64, n_hosts=4, t_cg=32.0,
                             backend=backend, device=device)
    groups = [np.arange(8 * g, 8 * g + 8) for g in range(8)]
    w = 1.0 / np.arange(1, 9) ** 1.1
    w /= w.sum()
    for _ in range(1200):
        g = groups[rng.choice(8, p=w)]
        mgr.observe(rng.choice(g, size=(8, 2)), host=int(rng.integers(0, 4)))
    st = mgr.stats()
    rows.append(("integration/expert_cache", 0,
                 f"cliques={len(st.cliques)};akpc={round(st.akpc_total, 1)};"
                 f"per_expert={round(st.nopack_total, 1)};"
                 f"saving={round(st.saving_pct, 1)}%"))
    payload["expert_cache"] = {"saving_pct": st.saving_pct,
                               "n_cliques": len(st.cliques)}
    return payload, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="session",
                    choices=("session", "live"))
    device_arg(ap)
    args = ap.parse_args(argv)
    payload, rows = run(args.backend, args.device)
    save_json("integration_bench_torch", payload)
    emit(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
