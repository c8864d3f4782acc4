"""Competitive analysis machinery (paper §IV.D, Theorems 1 and 2) on the device.

The port of ``repro.core.competitive``:

* ``competitive_bound(S, omega, alpha)`` (``cost.py``) is the Thm-1 ratio;
* :func:`adversarial_trace` realises the Thm-2 adversary: phases of requests
  for S always-fresh items, each of a DISTINCT pre-established clique of
  size exactly omega, issued > dt apart so every phase misses;
  :func:`replay_adversary` replays it on the device;
* :func:`per_request_ratio_check` replays any trace and verifies Thm 1
  request by request: the realised cost of a request divided by the
  theorem's OPT model for it never exceeds the bound;
* :func:`generalized_bound` / :func:`generalized_per_request_ratio_check`
  are the file-bundle generalisation (Qin & Etesami, arXiv 2011.03212):
  both sides of the worst request are priced through the cost model's
  hooks, so the bound follows per-server prices, item volumes and tiered
  transfer schedules.

The reference's per-request checks loop over ``ReplayEngine.
handle_request``; the port's host engine keeps state only, so
:func:`request_outcomes` replays the trace on the device at one request a
step with the replay's per-step record on (``run_schedule(record=)``):
each request's transfer, caching charge on its missed cliques and missed
items, read from the device once at the end.

Entry points take ``device=None``, which means ``"cuda"``; pass
``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..traces.loader import Trace
from .cliques import CliquePartition
from .cost import (
    CacheEnvironment,
    CostParams,
    competitive_bound_corrected,
    competitive_bound_env,
    get_cost_model,
)


@dataclasses.dataclass(frozen=True)
class AdversarySetup:
    trace: Trace
    partition: CliquePartition
    S: int
    omega: int


def adversarial_trace(
    S: int,
    omega: int,
    n_phases: int,
    params: CostParams,
    server: int = 0,
    m: int = 4,
) -> AdversarySetup:
    """Thm-2 adversary: phase l_i requests S uncached items of distinct
    omega-cliques at one server, spaced > dt so earlier caches expired."""
    n = n_phases * S * omega
    cliques = [
        tuple(range(c * omega, (c + 1) * omega)) for c in range(n_phases * S)
    ]
    part = CliquePartition.from_cliques(n, cliques)
    items = np.full((n_phases, S), -1, dtype=np.int32)
    for ph in range(n_phases):
        # one item from each of S distinct, never-seen cliques
        items[ph, :S] = [(ph * S + s) * omega for s in range(S)]
    gap = 2.0 * params.dt
    times = (1.0 + np.arange(n_phases) * gap).astype(np.float64)
    servers = np.full(n_phases, server, dtype=np.int32)
    trace = Trace(times=times, servers=servers, items=items, n=n, m=m,
                  name=f"adversary-S{S}-w{omega}")
    return AdversarySetup(trace=trace, partition=part, S=S, omega=omega)


def _engine(trace: Trace, partition: CliquePartition, params: CostParams,
            env, cost_model, device):
    """A device replay engine with ``partition`` installed at time 0, as
    the reference's checks set theirs up (requested caching charge, no
    seeding of new cliques)."""
    from .replay import TorchReplayEngine

    eng = TorchReplayEngine(trace.n, trace.m, params,
                            caching_charge="requested",
                            seed_new_cliques=False, env=env,
                            cost_model=cost_model, device=device)
    eng.install_partition(partition, now=0.0)
    return eng


def replay_adversary(
    setup: AdversarySetup,
    params: CostParams,
    env: CacheEnvironment | None = None,
    cost_model="table1",
    *,
    device=None,
) -> tuple[float, float, float]:
    """Returns (akpc_cost, opt_cost_model, bound), the adversary replayed
    on ``device``.

    Thm 2: the realised ratio equals the bound EXACTLY, for the bound that
    follows from the paper's case analysis (``competitive_bound_
    corrected``).  With a heterogeneous ``env`` the OPT model prices each
    phase's packed transfer under the SAME cost model and the bound is the
    max-over-servers generalisation ``competitive_bound_env``.
    """
    eng = _engine(setup.trace, setup.partition, params, env, cost_model,
                  device)
    eng.replay(setup.trace)
    akpc = eng.costs.total
    S = setup.S
    model = eng.engine.model
    # the Table-I closed form needs a homogeneous scenario AND Table-I
    # pricing; any other model prices OPT under its own hooks
    if (env is None or env.homogeneous) and model.name == "table1":
        per_phase_opt = (1.0 + (S - 1) * params.alpha) * params.lam
        opt = per_phase_opt * setup.trace.n_requests
        bound = competitive_bound_corrected(S, setup.omega, params.alpha)
    else:
        tr = setup.trace
        sizes = eng.engine.env.sizes()
        vols = np.where(tr.items >= 0, sizes[np.maximum(tr.items, 0)],
                        0.0).sum(axis=1)
        opt = float(model.transfer_cost_batch(
            np.full(tr.n_requests, S, dtype=np.int64), vols,
            tr.servers.astype(np.int64)).sum())
        bound = competitive_bound_env(eng.engine.env, S, setup.omega)
    return akpc, opt, bound


def generalized_bound(
    env: CacheEnvironment,
    S: int,
    omega: int,
    cost_model="table1",
) -> float:
    """File-bundle generalisation of the corrected Thm-1 bound, priced
    through the cost model's hooks (Qin & Etesami, arXiv 2011.03212,
    adapted to the keep-while-rented cache of this paper).

    Worst request at server j, S missed items: the online algorithm pays,
    per missed item, at most one full omega-clique transfer of the
    largest items plus the prepaid ``dt_j`` rent for the item itself —

        C_on(j)  = S * [ T(omega, omega*s_max, j) + R(1, s_max, j)*dt_j ]

    while the offline optimum's request model pays a single packed
    transfer of the S missed items at the smallest volumes —

        C_opt(j) = T(S, S*s_min, j)

    with ``T``/``R`` the model's ``transfer_cost_batch``/``caching_rate``.
    The bound is ``max_j C_on(j)/C_opt(j)``.  Under ``table1`` it is
    ``competitive_bound_corrected`` at rho = 1, under ``heterogeneous``
    ``competitive_bound_env``; for tiered schedules it is a bound no
    closed form covers.
    """
    if S < 1:
        raise ValueError("S must be >= 1")
    if omega < 1:
        raise ValueError("omega must be >= 1")
    model = get_cost_model(cost_model, env)
    m = max(env.m, 1)
    srv = np.arange(m, dtype=np.int64)
    sizes = env.sizes()
    s_max = float(sizes.max()) if sizes.size else 1.0
    s_min = float(sizes.min()) if sizes.size else 1.0
    dt_j = np.broadcast_to(np.asarray(model.dt(), np.float64), (m,))
    trans_on = np.asarray(model.transfer_cost_batch(
        np.full(m, omega, np.int64), np.full(m, omega * s_max), srv),
        np.float64)
    rent_on = np.asarray(model.caching_rate(
        np.ones(m, np.int64), np.full(m, s_max), srv), np.float64) * dt_j
    c_on = S * (trans_on + rent_on)
    c_opt = np.asarray(model.transfer_cost_batch(
        np.full(m, S, np.int64), np.full(m, S * s_min), srv), np.float64)
    return float(np.max(c_on / np.maximum(c_opt, 1e-300)))


def request_outcomes(
    trace: Trace,
    partition: CliquePartition,
    params: CostParams,
    env: CacheEnvironment | None = None,
    cost_model="table1",
    *,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, object]:
    """Replay ``trace`` on ``device`` one request a step from ``partition``
    (installed at time 0, no clique generation) and return, per request,
    its transfer, its caching charge on missed cliques and its missed
    items (the ``RequestOutcome`` fields ``transfer``, ``caching_miss``
    and ``n_missed_items`` of the reference's ``handle_request``), with
    the host engine (its resolved cost model and environment)."""
    eng = _engine(trace, partition, params, env, cost_model, device)
    eng.replay(trace, batch_size=1, record=True)
    rec = eng.last_record[: trace.n_requests]
    return (rec[:, 0], rec[:, 1], np.rint(rec[:, 2]).astype(np.int64),
            eng.engine)


def generalized_per_request_ratio_check(
    trace: Trace,
    partition: CliquePartition,
    params: CostParams,
    env: CacheEnvironment | None = None,
    cost_model="table1",
    *,
    device=None,
) -> float:
    """:func:`per_request_ratio_check` under the generalized bound: max
    over requests of (realised miss cost / hook-priced OPT request model),
    normalised by :func:`generalized_bound` at that request's S.  Returns
    the worst slack ratio (<= 1.0 iff the generalized bound holds on this
    trace under this cost model).
    """
    transfer, caching_miss, missed, eng = request_outcomes(
        trace, partition, params, env, cost_model, device=device)
    omega = max(len(c) for c in partition.cliques)
    sizes = eng.env.sizes()
    s_min = float(sizes.min()) if sizes.size else 1.0
    bounds: dict[int, float] = {}
    worst = 0.0
    for i in np.nonzero(missed)[0].tolist():   # S = 0: identical costs
        S = int(missed[i])
        cost_i = float(transfer[i]) + float(caching_miss[i])
        srv = np.array([int(trace.servers[i])], np.int64)
        opt_i = float(eng.model.transfer_cost_batch(
            np.array([S], np.int64), np.array([S * s_min]), srv)[0])
        if S not in bounds:
            bounds[S] = generalized_bound(eng.env, S, omega, eng.model)
        worst = max(worst, (cost_i / opt_i) / bounds[S])
    return worst


def per_request_ratio_check(
    trace: Trace,
    partition: CliquePartition,
    params: CostParams,
    *,
    device=None,
) -> float:
    """Max over requests of (AKPC miss cost) / (Thm-1 OPT request model),
    normalised by the corrected Thm-1 bound.

    Per the theorem's case analysis, a request with S uncached items costs
    AKPC at most S*(2+(omega-1)*alpha)*lam (clique transfers + dt rent for
    the missed items) while the OPT model pays one packed transfer
    (1+(S-1)*alpha)*lam; full-hit requests cost the same (caching only).
    Returns the worst slack ratio realised/bound (<= 1.0 iff the corrected
    theorem holds on this trace).
    """
    transfer, caching_miss, missed, _ = request_outcomes(
        trace, partition, params, device=device)
    omega = max(len(c) for c in partition.cliques)
    worst = 0.0
    for i in np.nonzero(missed)[0].tolist():   # S = 0: identical costs
        S = int(missed[i])
        cost_i = float(transfer[i]) + float(caching_miss[i])
        opt_i = (1.0 + (S - 1) * params.alpha) * params.lam
        bound = competitive_bound_corrected(S, omega, params.alpha)
        worst = max(worst, (cost_i / opt_i) / bound)
    return worst
