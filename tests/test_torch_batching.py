"""The port's continuous batcher (``repro_torch.serve.batching``) against the
JAX package's (``repro.serve.batching``): the same request streams through
both, every call's result compared.

The streams are the cases of ``tests/test_batching.py`` and of the batcher
tests in ``tests/test_infra.py``, replayed call for call, plus seeded random
streams (slot counts, prompt lengths including the empty prompt, token
budgets, deadlines, caches short enough to cap generation, sampled tokens).
At every step the two must agree on ``admit()``'s slots, ``step_inputs()``
(values and dtypes), ``observe()``'s finished rids, ``positions``,
``next_tokens``, ``active`` and ``pending``; at the end on the ``finished``
dict (each request's tokens, age and slot).
"""

import numpy as np
import pytest

from repro.serve import batching as ref
from repro_torch.serve import batching as port


class _Trace:
    """A batcher whose every call appends what it returned and the state it left."""

    def __init__(self, mod, *args, **kwargs):
        self.mod = mod
        self.b = mod.ContinuousBatcher(*args, **kwargs)
        self.log = []

    def submit(self, **spec):
        self.b.submit(self.mod.Request(**spec))
        self.log.append(("submit", self.b.pending))

    def admit(self):
        slots = self.b.admit()
        self.log.append(("admit", slots, self._state()))
        return slots

    def step_inputs(self):
        tokens, positions = self.b.step_inputs()
        self.log.append(("inputs", tokens.shape, str(tokens.dtype), tokens.tolist(), positions.shape,
                         str(positions.dtype), positions.tolist()))  # fmt: skip
        return tokens, positions

    def observe(self, sampled):
        done = [req.rid for req in self.b.observe(sampled)]
        self.log.append(("observe", done, self._state()))
        return done

    def _state(self):
        b = self.b
        return (b.positions.tolist(), str(b.positions.dtype), b.next_tokens.tolist(), str(b.next_tokens.dtype),
                [None if r is None else r.rid for r in b.slots], b.active, b.pending, b.drain_done())  # fmt: skip

    def final(self):
        return {rid: (r.generated, r.age, r.slot, r.done) for rid, r in self.b.finished.items()}


def _step(t, token=7):
    """One decode step feeding every slot the same sampled token (tests/test_batching.py)."""
    return t.observe(np.full((t.b.batch_slots,), token, np.int32))


def _fifo_admission_order(t):
    for i in range(4):
        t.submit(rid=i, prompt=[1, 2], max_new_tokens=4)
    t.admit()
    t.admit()  # no free slot
    while not t.b.drain_done():
        _step(t)
        t.admit()


def _slot_reuse_after_finish(t):
    t.submit(rid=0, prompt=[1], max_new_tokens=1)
    t.submit(rid=1, prompt=[1], max_new_tokens=8)
    t.submit(rid=2, prompt=[5, 6], max_new_tokens=2)
    t.admit()
    _step(t)
    t.admit()
    while not t.b.drain_done():
        _step(t)
        t.admit()


def _deadline_force_finishes_straggler(t):
    t.submit(rid=0, prompt=[1], max_new_tokens=1000, deadline_steps=3)
    t.admit()
    for _ in range(3):
        _step(t)


def _max_seq_caps_generation(t):
    t.submit(rid=0, prompt=[1], max_new_tokens=100)
    t.admit()
    while t.b.active:
        _step(t)


def _infra_admits_and_finishes(t):
    for rid in range(5):
        t.submit(rid=rid, prompt=[1, 2, 3], max_new_tokens=4)
    while not t.b.drain_done():
        t.admit()
        t.step_inputs()
        t.observe(np.full((2,), 7, np.int64))


def _infra_deadline_forces_finish(t):
    t.submit(rid=0, prompt=[1], max_new_tokens=1000, deadline_steps=3)
    t.admit()
    for _ in range(3):
        t.observe(np.zeros((1,), np.int64))


# (stream, ContinuousBatcher's arguments)
CASES = {
    "fifo_admission_order": (_fifo_admission_order, dict(batch_slots=2, max_seq=32)),
    "slot_reuse_after_finish": (_slot_reuse_after_finish, dict(batch_slots=2, max_seq=32, pad_token=0)),
    "deadline_force_finishes_straggler": (_deadline_force_finishes_straggler, dict(batch_slots=1, max_seq=64)),
    "max_seq_caps_generation": (_max_seq_caps_generation, dict(batch_slots=1, max_seq=4)),
    "infra_admits_and_finishes": (_infra_admits_and_finishes, dict(batch_slots=2, max_seq=32)),
    "infra_deadline_forces_finish": (_infra_deadline_forces_finish, dict(batch_slots=1, max_seq=64)),
}


def _run(stream, kwargs, mod):
    t = _Trace(mod, **kwargs)
    stream(t)
    return t.log, t.final()


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_streams_match(case):
    stream, kwargs = CASES[case]
    want_log, want_final = _run(stream, kwargs, ref)
    got_log, got_final = _run(stream, kwargs, port)
    assert got_log == want_log
    assert got_final == want_final
    assert want_final  # every case finishes at least one request


def _random_stream(seed):
    """A stream drawn from ``seed``: (ContinuousBatcher's arguments, its
    requests, the sampled tokens of each step)."""
    rng = np.random.default_rng(seed)
    slots = int(rng.integers(1, 5))
    max_seq = int(rng.integers(4, 20))
    pad = int(rng.integers(0, 3))
    specs = []
    for rid in range(int(rng.integers(0, 13))):
        prompt = rng.integers(0, 50, int(rng.integers(0, min(7, max_seq)))).tolist()
        deadline = None if rng.random() < 0.6 else int(rng.integers(1, 6))
        specs.append(dict(rid=rid, prompt=prompt, max_new_tokens=int(rng.integers(1, 7)), deadline_steps=deadline))
    sampled = rng.integers(0, 50, (400, slots)).astype(np.int32)
    return dict(batch_slots=slots, max_seq=max_seq, pad_token=pad), specs, sampled


def _drive(kwargs, specs, sampled, mod):
    """Submit every request, then admit / step_inputs / observe until drained."""
    t = _Trace(mod, **kwargs)
    for spec in specs:
        t.submit(**spec)
    steps = 0
    while not t.b.drain_done():
        t.admit()
        assert t.b.active <= kwargs["batch_slots"]
        t.step_inputs()
        t.observe(sampled[steps])
        steps += 1
        assert steps < len(sampled)
    return t.log, t.final()


@pytest.mark.parametrize("seed", range(20))
def test_random_streams_match(seed):
    kwargs, specs, sampled = _random_stream(seed)
    want_log, want_final = _drive(kwargs, specs, sampled, ref)
    got_log, got_final = _drive(kwargs, specs, sampled, port)
    assert got_log == want_log
    assert got_final == want_final
    # conservation (tests/test_infra.py's property): no request lost or duplicated
    assert sorted(got_final) == [spec["rid"] for spec in specs]
