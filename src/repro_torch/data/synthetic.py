"""Deterministic synthetic data pipeline. The port's own copy of
``repro.data.synthetic`` (numpy only): its batches are bit for bit the
reference's for every ``(seed, step, shard)``.

* **step-addressable**: batch(step) is a pure function of (seed, step,
  shard), so a restart regenerates any step's batch without data recovery,
* **host-sharded**: each host materializes only its slice of the global
  batch,
* **prefetchable**: an iterator wrapper keeps K steps in flight.

The token stream is a reproducible Zipf-ish mixture with enough structure
that a small model measurably learns: a hidden walk over vocab blocks plus
local repetition. Batches are numpy arrays; the train loop moves them to
its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["TokenPipeline", "make_batch", "Prefetcher"]


def make_batch(seed: int, step: int, *, batch: int, seq_len: int,
               vocab_size: int, shard: int = 0, num_shards: int = 1,
               dtype=np.int32) -> dict:
    """Pure function (seed, step, shard) -> {"tokens", "labels"}."""
    if batch % num_shards != 0:
        raise ValueError(f"batch={batch} is not divisible by "
                         f"num_shards={num_shards}")
    local = batch // num_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))
    # hidden state walk over 64 vocab "topics"
    topics = rng.integers(0, 64, (local, 1 + seq_len // 64 + 1))
    base = np.repeat(topics, 64, axis=1)[:, :seq_len + 1]
    width = max(vocab_size // 64, 2)
    offs = rng.zipf(1.5, (local, seq_len + 1)) % width
    toks = (base * width + offs) % vocab_size
    # local repetition: copy 8-grams forward with prob .25
    rep = rng.random((local, seq_len + 1)) < 0.25
    toks[:, 8:] = np.where(rep[:, 8:], toks[:, :-8], toks[:, 8:])
    toks = toks.astype(dtype)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class TokenPipeline:
    seed: int
    batch: int
    seq_len: int
    vocab_size: int
    shard: int = 0
    num_shards: int = 1

    def __call__(self, step: int) -> dict:
        return make_batch(self.seed, step, batch=self.batch,
                          seq_len=self.seq_len, vocab_size=self.vocab_size,
                          shard=self.shard, num_shards=self.num_shards)

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of K batches (host-side overlap)."""

    def __init__(self, pipeline: TokenPipeline, start_step: int = 0,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put(pipeline(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
