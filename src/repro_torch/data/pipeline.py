"""Training input pipeline: synthetic token stream + push-based prefetch.

``SyntheticLM`` generates deterministic pseudo-data (Zipf-ish token
distribution with learnable n-gram structure so loss decreases measurably);
its shards are NumPy's, bit for bit the JAX package's.
``PrefetchingLoader`` wraps any shard-indexed source with the staging cache
+ push server (the paper's delivery framework applied to the input path)
and double-buffers batches on a background thread so the accelerator never
waits.  It yields NumPy batches; the training loop moves them to the
device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.data.staging import PushServer, ShardRequest, StagingCache


class SyntheticLM:
    """Deterministic synthetic LM data, shard-addressable."""

    def __init__(self, vocab: int, seq_len: int, batch: int,
                 n_shards: int = 1024, codebooks: int = 1, seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.n_shards = n_shards
        self.codebooks = codebooks
        self.seed = seed

    def load_shard(self, shard_id: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + shard_id)
        shape = (self.batch, self.seq_len + 1)
        if self.codebooks > 1:
            shape = (self.batch, self.seq_len + 1, self.codebooks)
        # order-1 markov-ish stream: next token correlated with previous
        base = rng.integers(0, self.vocab, size=shape, dtype=np.int32)
        shifted = np.roll(base, 1, axis=1)
        mix = rng.random(shape) < 0.5
        tokens = np.where(mix, (shifted * 7 + 13) % self.vocab, base)
        return tokens.astype(np.int32)

    def batch_from_shard(self, shard: np.ndarray) -> dict:
        return {"tokens": shard[:, :-1], "labels": shard[:, 1:]}


class PrefetchingLoader:
    """Iterator of training batches backed by the push-based delivery layer.

    host -> StagingCache -> (miss) origin; PushServer watches the request
    stream and pushes shard N+1, N+2 ahead of use; a worker thread keeps a
    bounded queue of ready batches (double buffering).
    """

    def __init__(self, source: SyntheticLM, host: int = 0,
                 cache_bytes: int = 1 << 30, depth: int = 2,
                 n_steps: int | None = None):
        self.source = source
        self.host = host
        self.cache = StagingCache(cache_bytes, source.load_shard)
        self.server = PushServer({host: self.cache}, source.load_shard,
                                 source.n_shards)
        self.depth = depth
        self.n_steps = n_steps
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = 0
        while not self._stop.is_set():
            if self.n_steps is not None and step >= self.n_steps:
                self._q.put(None)
                return
            shard_id = step % self.source.n_shards
            self.server.observe(ShardRequest(float(step), self.host,
                                             shard_id))
            shard = self.cache.get(shard_id)
            batch = self.source.batch_from_shard(shard)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()

    @property
    def stats(self) -> dict:
        s = dict(self.cache.stats)
        s["pushes"] = self.server.pushes
        return s
