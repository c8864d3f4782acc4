"""Input pipeline with an AKPC-managed per-host shard cache.

The port of ``repro.data.pipeline``: the training corpus is a set of
token SHARDS held by an authoritative store (the paper's "cloud
server"); every training host (the paper's ESS) caches shards it recently
consumed.  Mixture sampling makes shards of one domain CO-ACCESSED, the
structure AKPC mines: co-accessed shards become cliques, are prefetched
as packed bundles at discounted transfer cost, and whole-clique TTL
extension keeps hot domains resident.

The token stream is numpy, seeded and blind to the cache backend: the
port yields the reference's batches bit for bit.  The shard requests go
through the port's :class:`~repro_torch.core.session.CacheSession`
(``backend="session"``) or the card-resident
:class:`~repro_torch.serving.live.LiveServingEngine` (``"live"``), on
CUDA unless the caller passes ``device="cpu"``.  The pipeline is
checkpointable (``state_dict`` / ``load_state_dict``) and reports the
cache-cost telemetry.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.cost import CacheEnvironment, CostParams
from ..core.policy import get_policy
from ..core.session import CacheSession


class ShardStore:
    """Authoritative token store: ``n_shards`` shards of ``shard_tokens``
    synthetic tokens each, grouped into ``n_domains`` mixture domains.

    Every shard also has an ON-WIRE byte size (``shard_bytes``): shards
    compress differently, so the bytes actually transferred/rented vary per
    shard even at a fixed token count.  ``item_sizes()`` exposes them as
    mean-1 volumes for the size-aware cost models — the AKPC cache
    then prices shard fetches by real bytes instead of "1 unit per shard".
    """

    def __init__(self, n_shards: int = 256, shard_tokens: int = 4096,
                 vocab: int = 32000, n_domains: int = 8, seed: int = 0):
        self.n_shards = n_shards
        self.shard_tokens = shard_tokens
        self.vocab = vocab
        self.n_domains = n_domains
        self.seed = seed
        self.domain_of = np.arange(n_shards) % n_domains
        # simulated compression ratio in [0.35, 1.0] (domain-correlated:
        # same-domain shards share vocabulary statistics)
        rng = np.random.default_rng((seed, 0xB17E5))
        dom_ratio = rng.uniform(0.45, 0.9, n_domains)
        ratio = np.clip(
            dom_ratio[self.domain_of] + rng.normal(0.0, 0.05, n_shards),
            0.35, 1.0,
        )
        self.shard_bytes = (ratio * shard_tokens * 4).astype(np.int64)

    def item_sizes(self) -> np.ndarray:
        """(n_shards,) mean-1 volumes proportional to on-wire bytes."""
        b = self.shard_bytes.astype(np.float64)
        return b / b.mean()

    def read(self, shard_id: int) -> np.ndarray:
        """Deterministic synthetic shard: domain-dependent unigram mixture."""
        rng = np.random.default_rng((self.seed, int(shard_id)))
        dom = int(self.domain_of[shard_id])
        # each domain favours a band of the vocab (gives the LM something
        # learnable and makes domains distinguishable)
        lo = (dom * self.vocab) // (2 * self.n_domains)
        band = rng.integers(lo, lo + self.vocab // 4, self.shard_tokens)
        uni = rng.integers(0, self.vocab, self.shard_tokens)
        mix = rng.random(self.shard_tokens) < 0.8
        return np.where(mix, band, uni).astype(np.int32)


@dataclasses.dataclass
class PipelineTelemetry:
    akpc_total: float = 0.0
    nopack_total: float = 0.0
    shards_fetched: int = 0
    batches: int = 0

    @property
    def saving_pct(self) -> float:
        if self.nopack_total <= 0:
            return 0.0
        return 100.0 * (1.0 - self.akpc_total / self.nopack_total)


class PackedDataPipeline:
    """Yields token batches; shard fetches flow through an AKPC cache.

    Each global batch samples a mixture domain (Zipf) per microbatch row and
    draws shards from it — the co-access signal.  The shard requests of a
    window are replayed through AKPC (items=shards, server=this host) on
    ``device`` (default CUDA).
    """

    def __init__(self, store: ShardStore, *, batch_rows: int, seq_len: int,
                 host_id: int = 0, n_hosts: int = 1, seed: int = 0,
                 params: CostParams | None = None, t_cg: float = 64.0,
                 cost_model: str = "table1", backend: str = "session",
                 device=None):
        if backend not in ("session", "live"):
            raise ValueError(f"unknown pipeline cache backend {backend!r}")
        self.store = store
        self.backend = backend
        self.batch_rows = batch_rows
        self.seq_len = seq_len
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.seed = seed
        self.step = 0
        params = params or CostParams(alpha=0.5, rho=4.0)
        # shard byte-sizes are the environment's item sizes; the default
        # table1 model ignores them (unit accounting, telemetry unchanged),
        # cost_model="tiered"/"heterogeneous" prices fetches by real bytes
        env = CacheEnvironment(
            n=store.n_shards, m=n_hosts, params=params,
            item_sizes=store.item_sizes(),
        )
        def _make_session():
            policy = get_policy(
                "akpc", params=params, t_cg=t_cg, top_frac=1.0,
                cost_model=cost_model)
            if backend == "live":
                # card-resident shard cache: per-step feeds buffer into
                # async device chunks; telemetry totals settle at chunk
                # granularity (exact after drain())
                from ..serving.live import LiveServingEngine

                return LiveServingEngine(
                    policy, store.n_shards, n_hosts, env=env, device=device)
            return CacheSession(policy, store.n_shards, n_hosts, env=env,
                                device=device)

        self._make_session = _make_session
        self.cache = self._make_session()
        self.params = params
        self.env = env
        self.cost_model = cost_model
        self.telemetry = PipelineTelemetry()
        self._retired_windows = 0

    # -- determinism / checkpointing ---------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict) -> None:
        # replay-free resume: the sampler is a pure function of (seed, step)
        self.step = int(state["step"])
        # the cache session is an online stream and cannot rewind; crash
        # recovery restarts the cost accounting from the restore point
        if self.cache.now >= float(self.step):
            self._retired_windows += self.cache.policy.n_windows
            self.cache = self._make_session()

    @property
    def windows(self) -> int:
        """Clique-generation windows of every cache session this pipeline
        ran, those a rewind replaced included."""
        return self._retired_windows + self.cache.policy.n_windows

    # -- sampling ------------------------------------------------------------
    def _sample_shards(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step, self.host_id))
        n_dom = self.store.n_domains
        w = 1.0 / np.arange(1, n_dom + 1) ** 1.2
        w /= w.sum()
        doms = rng.choice(n_dom, size=self.batch_rows, p=w)
        shard_ids = np.empty(self.batch_rows, np.int64)
        for i, d in enumerate(doms):
            members = np.nonzero(self.store.domain_of == d)[0]
            shard_ids[i] = rng.choice(members)
        return shard_ids

    def _account(self, shard_ids: np.ndarray, t: float) -> None:
        uniq = np.unique(shard_ids)
        d_max = 8
        rows = [uniq[lo : lo + d_max] for lo in range(0, len(uniq), d_max)]
        items = np.full((len(rows), d_max), -1, np.int32)
        for r, g in enumerate(rows):
            items[r, : len(g)] = g
        self.cache.feed(
            items,
            np.full(len(rows), self.host_id, np.int64),
            np.full(len(rows), t, np.float64),
        )
        self.telemetry.shards_fetched += len(uniq)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        """(batch_rows, seq_len + 1) int32 — inputs are [:, :-1], labels [:, 1:]."""
        step = self.step
        self.step += 1
        shard_ids = self._sample_shards(step)
        self._account(shard_ids, float(step))
        rng = np.random.default_rng((self.seed, step, self.host_id, 1))
        out = np.empty((self.batch_rows, self.seq_len + 1), np.int32)
        for i, sid in enumerate(shard_ids):
            toks = self.store.read(int(sid))
            off = int(rng.integers(0, max(1, len(toks) - self.seq_len - 1)))
            out[i] = toks[off : off + self.seq_len + 1]
        self.telemetry.batches += 1
        self.telemetry.akpc_total = self.cache.costs.total
        return out


class TokenBatcher:
    """Shapes pipeline rows into the train-step batch pytree
    {tokens (accum, mb, S), labels (accum, mb, S)}."""

    def __init__(self, pipeline: PackedDataPipeline, accum: int, microbatch: int):
        self.pipeline = pipeline
        self.accum = accum
        self.microbatch = microbatch
        assert pipeline.batch_rows == accum * microbatch

    # restart rewinds the underlying pipeline (fault-tolerance contract)
    def state_dict(self) -> dict:
        return self.pipeline.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.pipeline.load_state_dict(state)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        rows = next(self.pipeline)
        rows = rows.reshape(self.accum, self.microbatch, -1)
        return {
            "tokens": rows[..., :-1],
            "labels": rows[..., 1:],
        }
