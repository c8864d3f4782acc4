"""Fault tolerance: checkpoint/restart, failure injection, straggler
accounting (port of ``repro.distributed.fault_tolerance``).

One host runs the loop, so worker failures and stragglers are SIMULATED,
but the recovery machinery they exercise (atomic committed checkpoints,
restore into the initial state's structure, the data pipeline rewound to
the restored step) is the real code; the tests kill training mid-run and
check that the final parameters are bitwise those of an uninterrupted run.

* :class:`FailureInjector` raises :class:`WorkerFailure` at scheduled
  steps or with a seeded probability, once a step.
* :class:`StragglerPolicy` draws each step's simulated worker latencies
  (numpy, seeded as the reference's, so equal seeds give equal logs); a
  worker slower than ``slack x median`` is a straggler, and the policy
  WAITs, SKIPs its microbatch or races a BACKUP worker, logging the action
  and the realised step time.
* :class:`TrainController` runs the step loop: on a WorkerFailure it
  restores the latest committed checkpoint into ``init_state()``'s
  structure (dtypes and devices), rewinds the batches through
  ``load_state_dict`` and continues.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..checkpoint import CheckpointManager


class WorkerFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    p_fail: float = 0.0
    at_steps: tuple[int, ...] = ()
    seed: int = 0
    enabled: bool = True
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        """One-shot per step: a failure fires once, recovery then passes it
        (a real node is replaced after it dies)."""
        if not self.enabled or step in self._fired:
            return
        if step in self.at_steps:
            self._fired.add(step)
            raise WorkerFailure(f"injected failure at step {step}")
        if self.p_fail > 0:
            rng = np.random.default_rng((self.seed, step))
            if rng.random() < self.p_fail:
                self._fired.add(step)
                raise WorkerFailure(f"injected random failure at step {step}")


@dataclasses.dataclass
class StragglerPolicy:
    """Simulated straggler detection + mitigation accounting."""

    n_workers: int = 16
    slack: float = 2.0
    mode: str = "backup"           # wait | skip | backup
    seed: int = 0
    p_straggle: float = 0.05
    straggle_factor: float = 6.0
    base_step_s: float = 1.0
    log: list = dataclasses.field(default_factory=list)

    def step_time(self, step: int) -> float:
        rng = np.random.default_rng((self.seed, step, 7))
        t = self.base_step_s * (1.0 + 0.05 * rng.standard_normal(self.n_workers))
        straggle = rng.random(self.n_workers) < self.p_straggle
        t = np.where(straggle, t * self.straggle_factor, t)
        med = float(np.median(t))
        worst = float(t.max())
        if worst <= self.slack * med:
            realised, action = worst, "none"
        elif self.mode == "wait":
            realised, action = worst, "wait"
        elif self.mode == "skip":
            # drop the stragglers' microbatches; reweight the gradient
            realised = float(t[t <= self.slack * med].max())
            action = "skip"
        else:                        # a backup worker races the straggler
            backup = med * (1.0 + 0.1)
            realised = float(min(worst, self.slack * med + backup))
            action = "backup"
        self.log.append({"step": step, "median_s": med, "worst_s": worst,
                         "realised_s": realised, "action": action})
        return realised


class TrainController:
    """Crash-recoverable training loop (see the module docstring).

    ``train_step(params, opt, batch) -> (params, opt, stats)`` may update
    its arguments in place (``launch/train.py``'s step does): a restart
    draws fresh ones from ``init_state()`` and restores into their dtypes
    and devices, and a checkpoint is a host copy taken when it is saved."""

    def __init__(
        self,
        train_step: Callable,
        init_state: Callable,            # () -> (params, opt_state)
        batches,                         # iterator with state_dict/load_state_dict
        ckpt_dir,
        ckpt_every: int = 20,
        injector: FailureInjector | None = None,
        straggler: StragglerPolicy | None = None,
    ):
        self.train_step = train_step
        self.init_state = init_state
        self.batches = batches
        self.ckpt = CheckpointManager(ckpt_dir, keep=2, async_save=False)
        self.ckpt_every = ckpt_every
        self.injector = injector or FailureInjector(enabled=False)
        self.straggler = straggler
        self.restarts = 0
        self.history: list[dict] = []

    def _pipeline_state(self, step: int) -> dict:
        if hasattr(self.batches, "state_dict"):
            return self.batches.state_dict()
        return {"step": step}

    def _restore_or_init(self):
        params, opt = self.init_state()
        like = {"params": params, "opt": opt,
                "pipeline": self._pipeline_state(0)}
        step, tree, _meta = self.ckpt.restore_latest(like)
        if step is None:
            return 0, params, opt
        if hasattr(self.batches, "load_state_dict"):
            self.batches.load_state_dict(
                {k: int(v) for k, v in tree["pipeline"].items()})
        return step, tree["params"], tree["opt"]

    def run(self, total_steps: int, max_restarts: int = 10):
        attempt = 0
        while True:
            start, params, opt = self._restore_or_init()
            try:
                step = start
                it = iter(self.batches)
                while step < total_steps:
                    self.injector.check(step)
                    batch = next(it)
                    params, opt, stats = self.train_step(params, opt, batch)
                    if self.straggler is not None:
                        self.straggler.step_time(step)
                    step += 1
                    self.history.append(
                        {"step": step, "loss": float(stats["loss"])})
                    if step % self.ckpt_every == 0 or step == total_steps:
                        self.ckpt.save(step, {
                            "params": params, "opt": opt,
                            "pipeline": self._pipeline_state(step),
                        }, meta={"step": step})
                return params, opt
            except WorkerFailure as e:
                attempt += 1
                self.restarts += 1
                if attempt > max_restarts:
                    raise
                print(f"[fault-tolerance] {e} -> restarting "
                      f"(attempt {attempt})", flush=True)
