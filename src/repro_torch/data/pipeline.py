"""Deterministic sharded data pipeline: the port's copy of
``repro/data/pipeline.py`` (numpy only; ``RandomState`` draws, so every
batch equals the reference's bit for bit).

Production shape: each host reads only its shard of the token stream
(host-sharded loading), batches are formed per-host and assembled into
global arrays; a background prefetch thread keeps ``prefetch`` batches
ahead of the step loop. Determinism: the stream is a pure function of
(seed, step, shard) — a restarted/rescaled job regenerates exactly the
batches it would have seen (exactly-once semantics without a data journal).

The corpus here is synthetic (no datasets ship offline): a mixture of
Zipf-distributed "language" with induced bigram structure so LM losses are
meaningfully learnable for the examples.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["SyntheticLM", "Prefetcher", "make_batch_iter"]


class SyntheticLM:
    """Deterministic synthetic token stream with learnable structure."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0,
                 n_shards: int = 1, shard: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.seed = seed
        self.n_shards = n_shards
        self.shard = shard
        rng = np.random.RandomState(seed)
        # fixed bigram transition table (sparse, peaked) — learnable signal
        self._next = rng.randint(0, vocab_size, size=(vocab_size, 4))

    def batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        """Batch for a given global step (pure function — replayable)."""
        per = batch_size // self.n_shards if self.n_shards > 1 else batch_size
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) % (2**31) + self.shard)
        toks = np.empty((per, self.seq + 1), np.int32)
        toks[:, 0] = rng.randint(0, self.vocab, per)
        branch = rng.randint(0, 4, size=(per, self.seq))
        noise = rng.rand(per, self.seq) < 0.1
        rand_tok = rng.randint(0, self.vocab, size=(per, self.seq))
        for t in range(self.seq):
            nxt = self._next[toks[:, t], branch[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background-thread prefetch of an iterator (overlaps host data work
    with device compute)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def make_batch_iter(vocab_size: int, seq_len: int, batch_size: int,
                    *, seed: int = 0, start_step: int = 0,
                    n_steps: Optional[int] = None, prefetch: int = 2):
    """Prefetched, resumable batch iterator."""
    src = SyntheticLM(vocab_size, seq_len, seed)

    def gen():
        step = start_step
        while n_steps is None or step < start_step + n_steps:
            yield step, src.batch(step, batch_size)
            step += 1

    return Prefetcher(gen(), depth=prefetch)
