"""Deterministic, sharded, resumable token pipeline.

Two sources:
  * ``SyntheticLM``  -- seeded pseudo-corpus (Zipfian unigram + Markov-ish
    mixing) for tests/examples: a *learnable* distribution so tiny training
    runs show decreasing loss;
  * ``MemmapTokens`` -- flat binary token file (np.memmap), the production
    path: documents are sliced into (seq+1)-length windows.

Determinism & fault tolerance: batches are indexed by ``step`` -- the
pipeline is a pure function ``(seed, step, shard) -> batch``, so a restart
from a checkpoint at step k reproduces exactly the batches the lost run
would have seen (no iterator state to persist), and elastic reshards only
change the ``(shard, n_shards)`` mapping while preserving the global batch
sequence.

This module is this package's own copy of ``repro/train/data.py`` (numpy
only, host side as there): the same draws, so that the same ``(seed, step,
shard, n_shards)`` gives the same arrays bit for bit.  The training loop
(``repro_torch/train/loop.py``) moves a batch to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["SyntheticLM", "MemmapTokens", "make_batch_fn"]


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    seed: int = 0
    order: int = 1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # a fixed random bigram transition table with strong structure:
        # next-token = f(prev) + small noise -> learnable by tiny models
        self._next = rng.integers(0, self.vocab_size, size=(self.vocab_size,))

    def batch(self, step: int, batch_size: int, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard
        )
        b = batch_size // n_shards
        toks = np.empty((b, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=b)
        noise = rng.random((b, self.seq_len))
        for t in range(self.seq_len):
            follow = self._next[toks[:, t]]
            rand = rng.integers(0, self.vocab_size, size=b)
            toks[:, t + 1] = np.where(noise[:, t] < 0.9, follow, rand)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class MemmapTokens:
    path: str
    vocab_size: int
    seq_len: int
    dtype: str = "uint16"
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n_windows = (len(self._data) - 1) // self.seq_len

    def batch(self, step: int, batch_size: int, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + step))
        b = batch_size // n_shards
        idx = rng.integers(0, self._n_windows, size=batch_size)[
            shard * b : (shard + 1) * b
        ]
        rows = np.stack(
            [self._data[i * self.seq_len : i * self.seq_len + self.seq_len + 1]
             for i in idx]
        ).astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_batch_fn(source, batch_size: int):
    """(step) -> full global batch (host numpy)."""

    def fn(step: int) -> Dict[str, np.ndarray]:
        return source.batch(step, batch_size)

    return fn
