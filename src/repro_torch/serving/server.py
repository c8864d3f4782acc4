"""Batched decode server: continuous batching over ``Model.decode_step``.

The port of ``repro.serving.server``: a request queue, a fixed-size decode
batch with slot reuse, per-slot positions, EOS / length stopping, and (for
MoE models) a routing tap that can feed the AKPC
:class:`~repro_torch.serving.ExpertCacheManager`.  The step runs eagerly
on the model's device (no graph capture); the next tokens come back to the
host once a step.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np
import torch

from ..models.api import Model
from ..models.common import tree_leaves


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    def __init__(self, model: Model, params, *, batch_size: int = 4,
                 cache_len: int = 256, eos_id: int = -1,
                 routing_tap: Callable | None = None):
        self.model = model
        self.params = params
        self.device = model.device
        self.B = batch_size
        self.cache_len = cache_len
        self.eos = eos_id
        self.routing_tap = routing_tap
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * batch_size
        self.slot_pos = np.zeros(batch_size, np.int64)
        # a bf16 cache whatever the model's dtypes, as the reference
        self.cache = model.init_cache(batch_size, cache_len, torch.bfloat16)
        self._decode = model.decode_step
        self.steps = 0
        self._all: list[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self._all.append(req)

    def _fill_slots(self) -> None:
        admitted = []
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.popleft()
                self.slot_pos[i] = 0
                admitted.append(i)
        if admitted:
            # attention caches are masked by position, but a recurrent
            # leaf would leak the previous tenant's state: zero every
            # admitted slot (slot axis 1 of every leaf) in place, on the
            # server's own cache
            idx = torch.as_tensor(admitted, device=self.device)
            for leaf in tree_leaves(self.cache):
                leaf[:, idx] = 0

    def step(self) -> int:
        """One decode step for every active slot; returns #active."""
        self._fill_slots()
        active = [i for i in range(self.B) if self.slots[i] is not None]
        if not active:
            return 0
        tokens = np.zeros((self.B, 1), np.int32)
        for i in active:
            r = self.slots[i]
            p = int(self.slot_pos[i])
            tokens[i, 0] = r.prompt[p] if p < len(r.prompt) else (
                r.out[-1] if r.out else 0)
        # per-slot positions: slots fill at different times (staggered
        # arrivals), so each row decodes at ITS position
        pos = torch.as_tensor(self.slot_pos % self.cache_len,
                              dtype=torch.int32).to(self.device)
        logits, self.cache = self._decode(
            self.params, self.cache, torch.from_numpy(tokens).to(self.device),
            pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for i in active:
            r = self.slots[i]
            self.slot_pos[i] += 1
            if self.slot_pos[i] >= len(r.prompt):
                r.out.append(int(nxt[i]))
                if int(nxt[i]) == self.eos or len(r.out) >= r.max_new:
                    r.done = True
                    self.slots[i] = None
        self.steps += 1
        if self.routing_tap is not None:
            self.routing_tap(self.params, tokens)
        return len(active)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        while self.steps < max_steps and (self.queue or any(
                s is not None for s in self.slots)):
            self.step()
        return [r for r in self._all if r.done]
