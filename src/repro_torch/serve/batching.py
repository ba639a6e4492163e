"""Continuous batching scheduler (serving substrate).

Counterpart of ``repro/serve/batching.py``, the same semantics line for line,
its host bookkeeping in numpy as there.  A slot-based scheduler in the vLLM
style, sized for the static-shape decode step: the decode batch is a
fixed-capacity slot array; finished sequences free their slot and queued
requests are admitted at the next step.  The decode step sees a constant
(batch, max_seq) shape -- admission only mutates host-side bookkeeping plus
the tokens/positions fed in -- so the one CUDA graph the step is captured as
(``serve.decode.capture_serve_step``, the port's ``jax.jit``) is replayed for
every step and never captured again mid-serving.

The reference's quirk is kept: ``admit`` sets a slot's position to the
prompt's length and its next token to the prompt's last, so after a prefill
of the whole prompt the last prompt token is fed once more, one position
later.

Straggler/fault behaviour: a request exceeding ``max_new_tokens`` or
``deadline_steps`` is force-finished (the serving analogue of the step
watchdog in ``train/loop.py``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

__all__ = ["Request", "ContinuousBatcher"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    deadline_steps: Optional[int] = None
    # filled by the scheduler
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    age: int = 0

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        if self.deadline_steps is not None and self.age >= self.deadline_steps:
            return True
        return False


class ContinuousBatcher:
    """Fixed-slot continuous batching around a single-token decode step."""

    def __init__(self, batch_slots: int, max_seq: int, pad_token: int = 0):
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.pad_token = pad_token
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.finished: Dict[int, Request] = {}
        # per-slot decode state (host mirrors of what the model consumes)
        self.positions = np.zeros((batch_slots,), np.int32)
        self.next_tokens = np.full((batch_slots,), pad_token, np.int32)

    # ------------------------------------------------------------------ api
    def submit(self, req: Request) -> None:
        assert len(req.prompt) < self.max_seq, "prompt exceeds cache"
        self.queue.append(req)

    def admit(self) -> List[int]:
        """Fill free slots from the queue; returns newly admitted slot ids.

        The caller is responsible for prefilling the admitted prompts into
        the cache slots (``prefill`` per slot, or token-by-token feed)."""
        admitted = []
        for i in range(self.batch_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                req.slot = i
                self.slots[i] = req
                self.positions[i] = len(req.prompt)
                self.next_tokens[i] = req.prompt[-1] if req.prompt else self.pad_token
                admitted.append(i)
        return admitted

    def step_inputs(self):
        """(tokens (B,1), positions (B,)) for the decode step."""
        return self.next_tokens.reshape(-1, 1).copy(), self.positions.copy()

    def observe(self, sampled: np.ndarray) -> List[Request]:
        """Record one decode step's outputs; returns finished requests."""
        done: List[Request] = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(sampled[i])
            req.generated.append(tok)
            req.age += 1
            self.next_tokens[i] = tok
            self.positions[i] += 1
            if req.done or self.positions[i] >= self.max_seq - 1:
                self.finished[req.rid] = req
                done.append(req)
                self.slots[i] = None
                self.positions[i] = 0
                self.next_tokens[i] = self.pad_token
        return done

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def pending(self) -> int:
        return len(self.queue)

    def drain_done(self) -> bool:
        return self.active == 0 and not self.queue
