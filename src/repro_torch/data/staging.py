"""Host staging cache: the framework-side DTN.

Each training host owns a byte-budget LRU cache of dataset shards
(:class:`repro_torch.core.cache.LRUCache`, the paper's eviction choice).
The ``PushServer`` is the origin-side engine: it observes shard requests
from all hosts, classifies the consumers (a training job's fetch sequence is
a *program request* stream, perfectly periodic), and pushes the predicted
next shards before they are requested.

Host code (threads and NumPy), as in the JAX package: the same requests
give the same stats, pushes and eviction order.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import numpy as np

from repro_torch.core.cache import LRUCache


@dataclasses.dataclass
class ShardRequest:
    ts: float
    host: int
    shard_id: int


class StagingCache:
    """Per-host shard cache with single-flight fetch."""

    def __init__(self, capacity_bytes: int, fetch_fn: Callable[[int], bytes]):
        self.cache = LRUCache(capacity_bytes)
        self.store: dict[int, np.ndarray] = {}
        self.fetch_fn = fetch_fn
        self.lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0, "pushed_hits": 0}
        self._pushed: set[int] = set()

    def push(self, shard_id: int, data) -> None:
        """Server-initiated placement (pre-fetch)."""
        with self.lock:
            if not self.cache.contains(shard_id):
                self._place(shard_id, data)
                self._pushed.add(shard_id)
                self._evict_sync()

    def get(self, shard_id: int):
        with self.lock:
            if self.cache.contains(shard_id):
                self.cache.lookup(shard_id, 0)
                if shard_id in self._pushed:
                    self.stats["pushed_hits"] += 1
                    self._pushed.discard(shard_id)
                else:
                    self.stats["hits"] += 1
                return self.store[shard_id]
            self.stats["misses"] += 1
        data = self.fetch_fn(shard_id)
        with self.lock:
            self._place(shard_id, data)
            self._evict_sync()
        return data

    def _place(self, shard_id: int, data) -> None:
        self.cache.insert(shard_id, getattr(data, "nbytes", len(data)))
        self.store[shard_id] = data

    def _evict_sync(self) -> None:
        live = set(self.cache.keys())
        for k in list(self.store):
            if k not in live:
                del self.store[k]
                self._pushed.discard(k)


class PushServer:
    """Origin-side predictor: sequential-scan detection + push-ahead.

    A training job requests shards 0,1,2,... (deterministic program
    pattern); after `threshold` in-order requests from a host, the server
    pushes the next `lookahead` shards to that host's staging cache."""

    def __init__(self, caches: dict[int, StagingCache],
                 load_fn: Callable[[int], np.ndarray],
                 n_shards: int, threshold: int = 3, lookahead: int = 2):
        self.caches = caches
        self.load_fn = load_fn
        self.n_shards = n_shards
        self.threshold = threshold
        self.lookahead = lookahead
        self._last: dict[int, int] = {}
        self._streak: dict[int, int] = {}
        self.pushes = 0

    def observe(self, req: ShardRequest) -> None:
        last = self._last.get(req.host)
        if last is not None and req.shard_id == last + 1:
            self._streak[req.host] = self._streak.get(req.host, 0) + 1
        else:
            self._streak[req.host] = 0
        self._last[req.host] = req.shard_id
        if self._streak[req.host] >= self.threshold:
            cache = self.caches.get(req.host)
            for d in range(1, self.lookahead + 1):
                nxt = (req.shard_id + d) % self.n_shards
                if cache is not None and not cache.cache.contains(nxt):
                    cache.push(nxt, self.load_fn(nxt))
                    self.pushes += 1
