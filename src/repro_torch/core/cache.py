"""Byte-budget caches with LRU / LFU eviction (paper §IV-C1, §V-B1).

Data objects are cached at *chunk* granularity: a request for
``(obj, [tr_start, tr_end])`` maps to the set of fixed-length time chunks
covering that range.  Chunking is what makes the paper's dominant access
pattern — overlapping moving windows — cacheable: consecutive requests share
all but the newest chunk.

The paper finds LRU beats LFU at small cache sizes (recency matters for
moving-window consumers) and LFU only catches up when the cache holds the
whole working set; ``benchmarks/fig9_cache_sweep.py`` reproduces this.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import heapq
import math
from typing import Hashable, Iterator

import numpy as np

ChunkKey = tuple[int, int]          # (obj, chunk_index)

DEFAULT_CHUNK_SECONDS = 3600.0      # 1 hour of stream per chunk


def chunks_for_range(
    obj: int, tr_start: float, tr_end: float,
    chunk_seconds: float = DEFAULT_CHUNK_SECONDS,
) -> list[ChunkKey]:
    """Chunk keys covering [tr_start, tr_end) for a data object."""
    if tr_end <= tr_start:
        return []
    first = int(math.floor(tr_start / chunk_seconds))
    last = int(math.ceil(tr_end / chunk_seconds))
    return [(obj, c) for c in range(first, last)]


def chunk_bounds_bulk(
    tr_start: np.ndarray, tr_end: np.ndarray,
    chunk_seconds: float = DEFAULT_CHUNK_SECONDS,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`chunks_for_range` over request arrays.

    Returns ``(first, n_chunks)`` int64 arrays; a request's chunk indices are
    ``range(first[i], first[i] + n_chunks[i])``.  Uses the same float ops as
    the scalar path (divide, then floor/ceil) so boundaries agree exactly.
    """
    tr_start = np.asarray(tr_start, dtype=np.float64)
    tr_end = np.asarray(tr_end, dtype=np.float64)
    first = np.floor(tr_start / chunk_seconds).astype(np.int64)
    last = np.ceil(tr_end / chunk_seconds).astype(np.int64)
    n = np.where(tr_end <= tr_start, 0, last - first)
    return first, n


def chunk_bytes(rate_bytes_per_s: float,
                chunk_seconds: float = DEFAULT_CHUNK_SECONDS) -> int:
    return int(rate_bytes_per_s * chunk_seconds)


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    hit_bytes: int = 0
    miss_bytes: int = 0
    evictions: int = 0
    inserted_bytes: int = 0

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    @property
    def byte_hit_rate(self) -> float:
        tot = self.hit_bytes + self.miss_bytes
        return self.hit_bytes / tot if tot else 0.0


class Cache:
    """Interface: a byte-budget key->size cache."""

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self.used = 0
        self.stats = CacheStats()

    # subclasses implement: _touch, _insert, _evict_one, __contains__, keys
    def lookup(self, key: Hashable, size: int) -> bool:
        if self.contains(key):
            self.stats.hits += 1
            self.stats.hit_bytes += size
            self._touch(key)
            return True
        self.stats.misses += 1
        self.stats.miss_bytes += size
        return False

    def insert(self, key: Hashable, size: int) -> None:
        if size > self.capacity:
            return
        if self.contains(key):
            self._touch(key)
            return
        while self.used + size > self.capacity:
            self._evict_one()
            self.stats.evictions += 1
        self._insert(key, size)
        self.used += size
        self.stats.inserted_bytes += size

    def contains(self, key: Hashable) -> bool:
        raise NotImplementedError

    def _touch(self, key: Hashable) -> None:
        raise NotImplementedError

    def _insert(self, key: Hashable, size: int) -> None:
        raise NotImplementedError

    def _evict_one(self) -> None:
        raise NotImplementedError

    def keys(self) -> Iterator[Hashable]:
        raise NotImplementedError

    def __len__(self) -> int:
        return sum(1 for _ in self.keys())


class LRUCache(Cache):
    def __init__(self, capacity_bytes: int):
        super().__init__(capacity_bytes)
        self._od: collections.OrderedDict[Hashable, int] = collections.OrderedDict()

    def contains(self, key):
        return key in self._od

    def _touch(self, key):
        self._od.move_to_end(key)

    def _insert(self, key, size):
        self._od[key] = size

    def _evict_one(self):
        key, size = self._od.popitem(last=False)
        self.used -= size

    def evict_key(self, key) -> None:
        if key in self._od:
            self.used -= self._od.pop(key)

    def keys(self):
        return iter(self._od.keys())


class LFUCache(Cache):
    """LFU with a lazy min-heap of (freq, seq, key)."""

    def __init__(self, capacity_bytes: int):
        super().__init__(capacity_bytes)
        self._sizes: dict[Hashable, int] = {}
        self._freq: dict[Hashable, int] = {}
        self._heap: list[tuple[int, int, Hashable]] = []
        self._seq = 0

    def contains(self, key):
        return key in self._sizes

    def _touch(self, key):
        self._freq[key] += 1
        self._seq += 1
        heapq.heappush(self._heap, (self._freq[key], self._seq, key))

    def _insert(self, key, size):
        self._sizes[key] = size
        self._freq[key] = 1
        self._seq += 1
        heapq.heappush(self._heap, (1, self._seq, key))

    def _evict_one(self):
        while self._heap:
            freq, _, key = heapq.heappop(self._heap)
            if key in self._sizes and self._freq.get(key) == freq:
                self.used -= self._sizes.pop(key)
                del self._freq[key]
                return
        raise RuntimeError("evict from empty LFU cache")

    def keys(self):
        return iter(self._sizes.keys())


def make_cache(policy: str, capacity_bytes: int) -> Cache:
    policy = policy.lower()
    if policy == "lru":
        return LRUCache(capacity_bytes)
    if policy == "lfu":
        return LFUCache(capacity_bytes)
    raise ValueError(f"unknown cache policy: {policy}")


# ---------------------------------------------------------------------------
# Array-backed int-keyed cache state (vectorized engine hot path)
# ---------------------------------------------------------------------------
#
# The dict/heap caches above are the readable reference.  The vectorized
# replay engine (repro_torch.core.engine) addresses chunks as dense integers
# (obj * span + chunk + offset) and needs batch lookup/touch/insert over
# whole chunk-id arrays.  The classes below are *result-equivalent* to
# LRUCache/LFUCache: same hit/miss/eviction decisions in the same order,
# with state held in flat NumPy arrays instead of per-key Python objects.
#
# Equivalence notes (mirrors the reference implementations exactly):
# - LRU order == ascending "stamp" (one monotonic clock per cache);
#   eviction scans a lazily-invalidated FIFO of (stamp, key) records, so a
#   record is valid iff the key is present AND its stamp is current —
#   exactly the OrderedDict ordering.
# - LFU eviction order == min (freq, seq); the lazy min-heap keeps the
#   reference's validity rule (present AND freq matches the heap record).
# - Stats counters are plain ints, exported via to_cache_stats().


class IntCacheState:
    """Base for array-backed caches over dense int keys in [0, n_keys).

    ``present`` is an externally-owned bool row (one row of the engine's
    [n_dtn, n_keys] presence matrix) so peer lookups can gather presence
    across every cache in one vectorized read.
    """

    policy = "?"

    def __init__(self, capacity_bytes: int, n_keys: int, present: "np.ndarray"):
        self.capacity = int(capacity_bytes)
        self.used = 0
        self.n_live = 0
        self.present = present
        self.size = np.zeros(n_keys, np.int64)
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.miss_bytes = 0
        self.evictions = 0
        self.inserted_bytes = 0

    def record_lookup(self, n_hits: int, n_miss: int, per_chunk: int) -> None:
        self.hits += n_hits
        self.misses += n_miss
        self.hit_bytes += n_hits * per_chunk
        self.miss_bytes += n_miss * per_chunk

    def to_cache_stats(self) -> CacheStats:
        return CacheStats(self.hits, self.misses, self.hit_bytes,
                          self.miss_bytes, self.evictions, self.inserted_bytes)

    # subclasses: touch_hits, insert_batch, upsert_batch, _evict_one, remap


class _VecPlan:
    """Speculative eviction plan over an :class:`IntLRUState` FIFO scan.

    Holds candidate victims in exact eviction order with the stamps they
    carried when scanned.  The plan is *self-validating*: a victim is
    still a victim iff it is present with an unchanged stamp (re-touches
    re-stamp, evictions clear presence, and re-inserts after eviction get
    a newer stamp — a stale victim can never revalidate), so reuse only
    needs a filter pass, no invalidation hooks on the mutation paths.
    ``fgen`` guards the stored FIFO positions (``ends``/``pos``) against
    queue compaction, which renumbers them.
    """

    __slots__ = ("vk", "vst", "vsz", "ends", "pos", "fgen", "total")

    def __init__(self, pos: int, fgen: int):
        z = np.empty(0, np.int64)
        self.vk = z          # victim keys, eviction order
        self.vst = z         # their stamps at scan time
        self.vsz = z         # their sizes at scan time
        self.ends = z        # FIFO position just past each victim
        self.pos = pos       # scan frontier (next unscanned FIFO slot)
        self.fgen = fgen
        self.total = 0       # sum(vsz)


class IntLRUState(IntCacheState):
    """Array LRU, result-equivalent to :class:`LRUCache`."""

    policy = "lru"

    def __init__(self, capacity_bytes: int, n_keys: int, present: "np.ndarray"):
        super().__init__(capacity_bytes, n_keys, present)
        self.stamp = np.zeros(n_keys, np.int64)
        self._clock = 0
        self._fs = np.empty(4096, np.int64)      # FIFO: stamps
        self._fk = np.empty(4096, np.int64)      # FIFO: keys
        self._head = 0
        self._tail = 0
        self._plan: "_VecPlan | None" = None
        self._fgen = 0

    # -- FIFO plumbing -------------------------------------------------------

    def _fifo_reserve(self, m: int) -> None:
        if self._tail + m <= self._fs.size:
            return
        # drop invalidated records first; grow only if still cramped
        h, t = self._head, self._tail
        ks = self._fk[h:t]
        valid = self.present[ks] & (self.stamp[ks] == self._fs[h:t])
        n = int(valid.sum())
        cap = self._fs.size
        while n + m > cap // 2:
            cap *= 2
        fs = np.empty(cap, np.int64)
        fk = np.empty(cap, np.int64)
        fs[:n] = self._fs[h:t][valid]
        fk[:n] = ks[valid]
        self._fs, self._fk = fs, fk
        self._head, self._tail = 0, n
        self._fgen += 1                  # stored FIFO positions renumbered

    def _fifo_append(self, stamps: "np.ndarray", keys: "np.ndarray") -> None:
        m = len(keys)
        self._fifo_reserve(m)
        t = self._tail
        self._fs[t:t + m] = stamps
        self._fk[t:t + m] = keys
        self._tail = t + m

    def _fifo_append_one(self, stamp: int, key: int) -> None:
        self._fifo_reserve(1)
        self._fs[self._tail] = stamp
        self._fk[self._tail] = key
        self._tail += 1

    # -- batch ops -----------------------------------------------------------

    def touch_hits(self, keys: "np.ndarray") -> None:
        """Touch distinct present keys, in array order (ascending stamps)."""
        m = len(keys)
        stamps = np.arange(self._clock, self._clock + m, dtype=np.int64)
        self.stamp[keys] = stamps
        self._fifo_append(stamps, keys)
        self._clock += m

    def commit_unique(self, keys: "np.ndarray", ranks: "np.ndarray",
                      insert_mask: "np.ndarray", sizes: "np.ndarray",
                      rank_span: int) -> None:
        """Commit one replay block given ONE record per distinct key, sorted
        by recency rank (the key's last touch in reference order).  Stamps
        are ``clock + rank`` — sparse, but LRU order only needs monotonicity.
        The caller pre-applied any needed evictions, so capacity holds."""
        m = len(keys)
        if m == 0:
            return
        stamps = self._clock + ranks
        self._clock += rank_span
        self.stamp[keys] = stamps
        self._fifo_append(stamps, keys)
        ik = keys[insert_mask]
        if len(ik):
            szs = sizes[insert_mask]
            self.present[ik] = True
            self.size[ik] = szs
            tot = int(szs.sum())
            self.used += tot
            self.n_live += len(ik)
            self.inserted_bytes += tot

    def insert_batch(self, keys: "np.ndarray", size_each: int) -> None:
        """Insert distinct absent keys in array order."""
        m = len(keys)
        if m == 0 or size_each > self.capacity:
            return
        need = m * size_each
        if self.used + need <= self.capacity:
            stamps = np.arange(self._clock, self._clock + m, dtype=np.int64)
            self.present[keys] = True
            self.size[keys] = size_each
            self.stamp[keys] = stamps
            self._fifo_append(stamps, keys)
            self._clock += m
            self.used += need
            self.n_live += m
            self.inserted_bytes += need
            return
        for k in keys.tolist():
            while self.used + size_each > self.capacity:
                self._evict_one()
            self.present[k] = True
            self.size[k] = size_each
            self.stamp[k] = self._clock
            self._fifo_append_one(self._clock, k)
            self._clock += 1
            self.used += size_each
            self.n_live += 1
            self.inserted_bytes += size_each

    def upsert_batch(self, keys: "np.ndarray", size_each: int) -> None:
        """insert() semantics per key, in order: touch if present, else
        evict-to-fit and insert (stream pushes hit this mixed case)."""
        m = len(keys)
        if m == 0:
            return
        pm = self.present[keys]
        n_new = m - int(pm.sum())
        if size_each > self.capacity:
            hk = keys[pm]
            if len(hk):
                self.touch_hits(hk)
            return
        need = n_new * size_each
        if self.used + need <= self.capacity:
            stamps = np.arange(self._clock, self._clock + m, dtype=np.int64)
            self.stamp[keys] = stamps
            self._fifo_append(stamps, keys)
            self._clock += m
            if n_new:
                nk = keys[~pm]
                self.present[nk] = True
                self.size[nk] = size_each
                self.used += need
                self.n_live += n_new
                self.inserted_bytes += need
            return
        self.upsert_seq(keys.tolist(), size_each)

    def upsert_seq(self, keys: list, size_each: int) -> None:
        """Scalar upsert loop — same semantics as :meth:`upsert_batch`, used
        directly for tiny batches (stream pushes are 1-2 chunks) where NumPy
        call dispatch would dominate."""
        if size_each > self.capacity:
            for k in keys:
                if self.present[k]:
                    self.stamp[k] = self._clock
                    self._fifo_append_one(self._clock, k)
                    self._clock += 1
            return
        for k in keys:
            if self.present[k]:
                self.stamp[k] = self._clock
                self._fifo_append_one(self._clock, k)
                self._clock += 1
                continue
            while self.used + size_each > self.capacity:
                self._evict_one()
            self.present[k] = True
            self.size[k] = size_each
            self.stamp[k] = self._clock
            self._fifo_append_one(self._clock, k)
            self._clock += 1
            self.used += size_each
            self.n_live += 1
            self.inserted_bytes += size_each

    def plan_evictions(self, need: int, blocked_mask: "np.ndarray"
                       ) -> tuple["np.ndarray", "np.ndarray", "np.ndarray"]:
        """Dry-run the eviction scan: find victims (in exact eviction order)
        to free ≥ ``need`` bytes, stopping early at any victim whose key is
        marked in ``blocked_mask`` (keys the current replay block touches —
        evicting those would change in-block hit/peer decisions, so the
        caller must truncate the block there instead).

        Returns ``(victim_keys, cum_freed_bytes, entries_consumed_through)``,
        possibly freeing less than ``need``.  Nothing is mutated; pass a
        prefix count to :meth:`apply_evictions` to commit.
        """
        pos, t = self._head, self._tail
        vk_parts: list[np.ndarray] = []
        sz_parts: list[np.ndarray] = []
        end_parts: list[np.ndarray] = []
        freed = 0
        while pos < t and freed < need:
            e = min(pos + 2048, t)
            kk = self._fk[pos:e]
            val = self.present[kk] & (self.stamp[kk] == self._fs[pos:e])
            if pos == self._head:
                # permanently drop leading stale records (the reference pops
                # them silently whenever an eviction walks past; doing it now
                # keeps repeated plans from rescanning the same dead prefix)
                lead = int(np.argmax(val)) if val.any() else len(val)
                self._head += lead
            amb = val & blocked_mask[kk]
            stop = None
            if amb.any():
                stop = int(np.argmax(amb))
                kk = kk[:stop]
                val = val[:stop]
            vi = val.nonzero()[0]
            if len(vi):
                keys_v = kk[vi]
                vk_parts.append(keys_v)
                sz_parts.append(self.size[keys_v])
                end_parts.append(pos + vi + 1)
                freed += int(sz_parts[-1].sum())
            if stop is not None:
                break
            pos = e
        if not vk_parts:
            z = np.empty(0, np.int64)
            return z, z, z
        vk = np.concatenate(vk_parts)
        cum = np.concatenate(sz_parts).cumsum()
        ends = np.concatenate(end_parts)
        return vk, cum, ends

    def plan_evictions_spec(self, need: int, blocked_mask: "np.ndarray",
                            thresh: int | None = None
                            ) -> tuple["np.ndarray", "np.ndarray", "np.ndarray"]:
        """:meth:`plan_evictions` through a reusable speculative plan.

        Scans *past* blocked victims (over-planning ~2x ``need``) and keeps
        the plan on the state, so the next call — after a block truncation,
        an applied eviction, or a later block — revalidates the surviving
        victims instead of rescanning the FIFO.  Returns the same
        ``(victim_keys, cum_freed_bytes, entries_consumed_through)`` triple
        truncated at the first *currently* blocked victim, so the result is
        exactly a fresh :meth:`plan_evictions` scan: plan victims are kept
        only while present with unchanged stamps, which is precisely the
        FIFO records a fresh scan would accept over the scanned prefix.

        With ``thresh``, ``blocked_mask`` is instead an int64 last-occurrence
        array and a key is blocked iff ``blocked_mask[key] >= thresh`` —
        the engine's per-block monotone position index, which avoids a
        per-boundary O(suffix) mark/unmark sweep over the key space.
        """
        p = self._plan
        if p is None or p.fgen != self._fgen:
            p = self._plan = _VecPlan(self._head, self._fgen)
        while True:
            if len(p.vk):
                # drop consumed (behind the queue head) and stale victims
                val = (p.ends > self._head) & self.present[p.vk] \
                    & (self.stamp[p.vk] == p.vst)
                if not val.all():
                    p.vk = p.vk[val]
                    p.vst = p.vst[val]
                    p.vsz = p.vsz[val]
                    p.ends = p.ends[val]
                    p.total = int(p.vsz.sum())
            nvk = len(p.vk)
            stop = nvk
            if nvk:
                amb = (blocked_mask[p.vk] if thresh is None
                       else blocked_mask[p.vk] >= thresh)
                if amb.any():
                    stop = int(np.argmax(amb))
            cum = p.vsz[:stop].cumsum()
            freed = int(cum[-1]) if stop else 0
            if freed >= need or stop < nvk or p.pos >= self._tail:
                return p.vk[:stop], cum, p.ends[:stop]
            self._plan_scan_vec(p, need)

    def _plan_scan_vec(self, p: "_VecPlan", need: int) -> None:
        """Extend a plan's victim list from its scan frontier until the
        planned bytes reach ~2x ``need`` or the FIFO is exhausted.  Pure
        except for the head-stale drop :meth:`plan_evictions` also does."""
        t = self._tail
        target = 2 * need
        pos = p.pos
        vk_parts: list[np.ndarray] = []
        st_parts: list[np.ndarray] = []
        sz_parts: list[np.ndarray] = []
        end_parts: list[np.ndarray] = []
        got = 0
        while pos < t and p.total + got < target:
            e = min(pos + 2048, t)
            kk = self._fk[pos:e]
            val = self.present[kk] & (self.stamp[kk] == self._fs[pos:e])
            if pos == self._head:
                # an empty plan at the queue head: permanently drop leading
                # stale records, exactly like plan_evictions (a nonempty
                # plan implies pos > head, so this never skips plan victims)
                lead = int(np.argmax(val)) if val.any() else len(val)
                self._head += lead
            vi = val.nonzero()[0]
            if len(vi):
                kv = kk[vi]
                vk_parts.append(kv)
                st_parts.append(self.stamp[kv].copy())
                sz_parts.append(self.size[kv])
                end_parts.append(pos + vi + 1)
                got += int(sz_parts[-1].sum())
            pos = e
        p.pos = pos
        if vk_parts:
            p.vk = np.concatenate([p.vk] + vk_parts)
            p.vst = np.concatenate([p.vst] + st_parts)
            p.vsz = np.concatenate([p.vsz] + sz_parts)
            p.ends = np.concatenate([p.ends] + end_parts)
            p.total += got

    def apply_evictions(self, victim_keys: "np.ndarray", cum_freed: "np.ndarray",
                        entries_end: "np.ndarray", n: int) -> None:
        """Commit the first ``n`` planned evictions (exact reference order)."""
        if n == 0:
            return
        vk = victim_keys[:n]
        self.present[vk] = False
        self.used -= int(cum_freed[n - 1])
        self.n_live -= n
        self.evictions += n
        self._head = int(entries_end[n - 1])

    def touch_one(self, k: int) -> None:
        """Scalar hit-touch (tiny-request fast path in the replay engine)."""
        self.stamp[k] = self._clock
        self._fifo_append_one(self._clock, k)
        self._clock += 1

    def insert_one(self, k: int, size: int) -> None:
        """Scalar insert() with full reference semantics."""
        if size > self.capacity:
            return
        if self.present[k]:
            self.touch_one(k)
            return
        while self.used + size > self.capacity:
            self._evict_one()
        self.present[k] = True
        self.size[k] = size
        self.stamp[k] = self._clock
        self._fifo_append_one(self._clock, k)
        self._clock += 1
        self.used += size
        self.n_live += 1
        self.inserted_bytes += size

    def _evict_one(self) -> None:
        fs, fk, present, stamp = self._fs, self._fk, self.present, self.stamp
        h, t = self._head, self._tail
        while h < t:
            k = int(fk[h])
            s = fs[h]
            h += 1
            if present[k] and stamp[k] == s:
                present[k] = False
                self.used -= int(self.size[k])
                self.n_live -= 1
                self.evictions += 1
                self._head = h
                return
        self._head = h
        raise RuntimeError("evict from empty LRU state")

    def remap(self, mapper, n_keys_new: int, present_new: "np.ndarray") -> None:
        """Re-key all state after the engine grows its chunk-address space.
        ``mapper`` maps old key arrays to new keys (a pure renaming)."""
        self._plan = None                        # plan victims hold old keys
        idx = np.nonzero(self.present)[0]
        nidx = mapper(idx)
        size = np.zeros(n_keys_new, np.int64)
        stamp = np.zeros(n_keys_new, np.int64)
        size[nidx] = self.size[idx]
        stamp[nidx] = self.stamp[idx]
        present_new[nidx] = True
        self.size, self.stamp, self.present = size, stamp, present_new
        h, t = self._head, self._tail
        if t > h:
            self._fk[h:t] = mapper(self._fk[h:t])


class IntLFUState(IntCacheState):
    """Array LFU, result-equivalent to :class:`LFUCache`."""

    policy = "lfu"

    def __init__(self, capacity_bytes: int, n_keys: int, present: "np.ndarray"):
        super().__init__(capacity_bytes, n_keys, present)
        self.freq = np.zeros(n_keys, np.int64)
        self._heap: list[tuple[int, int, int]] = []
        self._seq = 0

    def touch_hits(self, keys: "np.ndarray") -> None:
        self.freq[keys] += 1
        fs = self.freq[keys]
        push = heapq.heappush
        for f, k in zip(fs.tolist(), keys.tolist()):
            self._seq += 1
            push(self._heap, (f, self._seq, k))

    def insert_batch(self, keys: "np.ndarray", size_each: int) -> None:
        m = len(keys)
        if m == 0 or size_each > self.capacity:
            return
        need = m * size_each
        push = heapq.heappush
        if self.used + need <= self.capacity:
            self.present[keys] = True
            self.size[keys] = size_each
            self.freq[keys] = 1
            for k in keys.tolist():
                self._seq += 1
                push(self._heap, (1, self._seq, k))
            self.used += need
            self.n_live += m
            self.inserted_bytes += need
            return
        for k in keys.tolist():
            while self.used + size_each > self.capacity:
                self._evict_one()
            self.present[k] = True
            self.size[k] = size_each
            self.freq[k] = 1
            self._seq += 1
            push(self._heap, (1, self._seq, k))
            self.used += size_each
            self.n_live += 1
            self.inserted_bytes += size_each

    def upsert_batch(self, keys: "np.ndarray", size_each: int) -> None:
        if len(keys) == 0:
            return
        self.upsert_seq(keys.tolist(), size_each)

    def upsert_seq(self, keys: list, size_each: int) -> None:
        push = heapq.heappush
        if size_each > self.capacity:
            for k in keys:
                if self.present[k]:
                    self.freq[k] += 1
                    self._seq += 1
                    push(self._heap, (int(self.freq[k]), self._seq, k))
            return
        for k in keys:
            if self.present[k]:
                self.freq[k] += 1
                self._seq += 1
                push(self._heap, (int(self.freq[k]), self._seq, k))
                continue
            while self.used + size_each > self.capacity:
                self._evict_one()
            self.present[k] = True
            self.size[k] = size_each
            self.freq[k] = 1
            self._seq += 1
            push(self._heap, (1, self._seq, k))
            self.used += size_each
            self.n_live += 1
            self.inserted_bytes += size_each

    def _evict_one(self) -> None:
        heap, present, freq = self._heap, self.present, self.freq
        while heap:
            f, _, k = heapq.heappop(heap)
            if present[k] and freq[k] == f:
                present[k] = False
                self.used -= int(self.size[k])
                self.n_live -= 1
                self.evictions += 1
                return
        raise RuntimeError("evict from empty LFU state")

    def remap(self, mapper, n_keys_new: int, present_new: "np.ndarray") -> None:
        idx = np.nonzero(self.present)[0]
        nidx = mapper(idx)
        size = np.zeros(n_keys_new, np.int64)
        freq = np.zeros(n_keys_new, np.int64)
        size[nidx] = self.size[idx]
        freq[nidx] = self.freq[idx]
        present_new[nidx] = True
        self.size, self.freq, self.present = size, freq, present_new
        self._heap = [(f, s, int(nk)) for (f, s, k), nk in
                      zip(self._heap, mapper(np.fromiter(
                          (k for _, _, k in self._heap), np.int64,
                          len(self._heap))).tolist())]


def make_int_cache_state(policy: str, capacity_bytes: int, n_keys: int,
                         present: "np.ndarray") -> IntCacheState:
    policy = policy.lower()
    if policy == "lru":
        return IntLRUState(capacity_bytes, n_keys, present)
    if policy == "lfu":
        return IntLFUState(capacity_bytes, n_keys, present)
    raise ValueError(f"unknown cache policy: {policy}")


# ---------------------------------------------------------------------------
# Interval-algebra cache state (interval engine hot path)
# ---------------------------------------------------------------------------
#
# The array-backed states above still pay O(chunks) per request: presence is
# a bitmap and LRU recency a per-chunk FIFO, so halving ``chunk_seconds``
# doubles the serving work.  A request, however, is always ONE contiguous
# chunk-id range ``[lo, hi)`` (one object, one time range), and the paper's
# dominant access pattern — overlapping moving windows — keeps each cache's
# coverage in a handful of contiguous runs.  IntervalLRUState exploits that:
# presence, per-chunk sizes AND recency live in one sorted list of disjoint
# ``[start, end)`` segments, so the hit/miss split is an interval
# intersection, misses are interval subtraction, and eviction planning walks
# interval *records* — all O(overlapping segments), independent of how many
# chunks a segment spans.
#
# Exact-equivalence scheme (mirrors LRUCache chunk for chunk):
# - Every touch/insert of a maximal chunk run appends one *record*
#   ``(rid, lo, hi)`` to a FIFO; rids increase monotonically, and within a
#   record recency increases with chunk id — exactly the per-chunk stamp
#   order of the reference (hits are touched in ascending chunk order, then
#   misses inserted in ascending order).
# - Each map segment carries the rid of its latest touch.  A record is valid
#   for exactly the sub-segments that still carry its rid (lazy
#   invalidation, the same rule as the reference's stale-stamp FIFO).
# - Eviction pops records oldest-first and evicts their valid segments in
#   ascending chunk order, splitting a segment when only part of it is
#   needed — the reference's one-chunk-at-a-time loop, run arithmetically.


class EvictPlan:
    """Speculative eviction plan shared by the interval cache states
    (:class:`IntervalLRUState` and
    :class:`repro_torch.core.interval_store.FlatIntervalState`).

    Holds the candidate victim *runs* of the owner's FIFO scan, in exact
    LRU eviction order, with per-run and cumulative byte prices.  Built by
    ``get_evict_plan(max_need)``, which over-plans ~2x ``max_need`` so one
    scan serves several block-truncation queries (and, on the flat state,
    the evictions that later consume the planned prefix).

    Validity contract (the owner enforces it with guards): a plan may be
    consulted only while **no mutation has touched a planned victim run**
    — commits or touches overlapping ``[vs, ve)`` drop the plan, and
    evictions either consume the plan in order (flat state) or drop it.
    Under that invariant the plan prefix is exactly what a fresh FIFO scan
    would find, because untouched runs keep their record ids and byte
    prices, and the FIFO order of the scanned records cannot change.

    ``ks``/``ke`` are start-sorted copies of the victim runs for overlap
    stabs (disjoint runs, so ends are sorted too).  They are rebuilt on
    extension but deliberately left stale after a partial consume: a
    consumed run can then only cause a *spurious* invalidation (safe),
    never a missed one.
    """

    __slots__ = ("owner", "vs", "ve", "vobj", "vrec", "segb", "cumb",
                 "total", "pos", "fgen", "flen", "exhausted", "ks", "ke",
                 "kmin", "kmax")

    def __init__(self, owner):
        self.owner = owner
        z = np.empty(0, np.int64)
        self.vs = z          # victim run starts (global keys), LRU order
        self.ve = z          # victim run ends
        self.vobj = None     # per-run object ids (list state only)
        self.vrec = z        # per-run FIFO record position (flat state)
        self.segb = z        # per-run bytes
        self.cumb = z        # cumulative bytes
        self.total = 0
        self.pos = 0         # scan frontier (flat state FIFO index)
        self.fgen = 0        # owner FIFO generation at build (flat state)
        self.flen = 0        # owner FIFO length at build (list state)
        self.exhausted = False   # the scan consumed the whole FIFO
        self.ks = z
        self.ke = z
        self.kmin = 0
        self.kmax = 0

    def _index(self) -> None:
        order = np.argsort(self.vs, kind="stable")
        self.ks = self.vs[order]
        self.ke = self.ve[order]
        if len(self.ks):
            self.kmin = int(self.ks[0])
            self.kmax = int(self.ke[-1])
        else:
            self.kmin = self.kmax = 0

    def overlaps(self, lo: int, hi: int) -> bool:
        """Does ``[lo, hi)`` overlap any (possibly already consumed)
        planned victim run?  Start-sorted disjoint runs have sorted ends,
        so one stab decides."""
        if hi <= self.kmin or lo >= self.kmax:
            return False
        i = int(self.ks.searchsorted(hi, side="left"))
        return i > 0 and int(self.ke[i - 1]) > lo

    def clean_before(self, max_need: int, blocked_starts,
                     blocked_ends) -> int:
        """Bytes freeable in exact LRU order before the first planned
        victim chunk inside a blocked run, clamped at ``max_need`` — the
        ``plan_evict_clean`` result.  Well-defined whenever the plan
        satisfies ``total >= max_need`` or is exhausted: any such plan
        gives the same answer as the full scan, because the answer only
        depends on the victim prefix up to the first cut or the
        ``max_need`` clamp, whichever comes first."""
        vs, ve = self.vs, self.ve
        if len(vs) == 0:
            return min(self.total, max_need)
        bs = blocked_starts if isinstance(blocked_starts, np.ndarray) \
            else np.asarray(blocked_starts, np.int64)
        be = blocked_ends if isinstance(blocked_ends, np.ndarray) \
            else np.asarray(blocked_ends, np.int64)
        nb = len(bs)
        if nb == 0:
            return min(self.total, max_need)
        bi = bs.searchsorted(vs, side="right") - 1
        covered = (bi >= 0) & (be[np.maximum(bi, 0)] > vs)
        cand = np.where(bi + 1 < nb, bs[np.minimum(bi + 1, nb - 1)],
                        np.iinfo(np.int64).max)
        stop = np.minimum(ve, cand)
        ci = (covered | (stop < ve)).nonzero()[0]
        if not len(ci):
            return min(self.total, max_need)
        fb = int(ci[0])
        base = int(self.cumb[fb - 1]) if fb > 0 else 0
        if not covered[fb]:
            obj = int(self.vobj[fb]) if self.vobj is not None else -1
            base += self.owner._plan_seg_bytes(obj, int(vs[fb]),
                                               int(stop[fb]))
        return min(base, max_need)


class IntervalLRUState:
    """LRU cache state over dense int chunk keys, held as sorted disjoint
    ``[start, end)`` intervals.  Result-equivalent to :class:`LRUCache` /
    :class:`IntLRUState`: identical hit/miss/eviction decisions in identical
    order, verified by ``tests/test_torch_interval_cache.py`` and the
    engine-level counter contract in ``tests/test_torch_engine_interval.py``.

    Two segment maps, both bucketed per data object (a request's chunk
    range never crosses objects, so every update splices a small
    per-object list):

    - the *recency map* ``obj -> [starts, ends, rids]`` carries presence
      and LRU order; every touch coalesces the whole touched range under
      one fresh record id, so the paper's moving-window pattern keeps it
      at a handful of segments per object regardless of chunk resolution;
    - the *size map* ``obj -> [starts, ends, sizes]`` carries per-chunk
      byte sizes for capacity accounting.  It fragments at request-size
      boundaries, but is only walked on insert and eviction — never on
      the hit path.

    LRU order: every touch/insert of a chunk run appends one record
    ``(rid, obj, lo, hi, src)`` to a FIFO; rids increase monotonically and
    recency increases with chunk id inside a record — exactly the
    reference's per-chunk stamp order (hits touched in ascending chunk
    order, then misses inserted ascending).  A record is valid for the
    sub-segments that still carry its rid (lazy invalidation); eviction
    pops records oldest-first and consumes their valid segments in
    ascending order, splitting segments when only part is needed.

    Used by the interval replay engine's static serving path (one instance
    per DTN; see ``engine.IntervalVDCSimulator``).  Its calls and records
    keep ``repro``'s request positions (``req_pos``, ``src``) although
    nothing here reads them back, so that one op stream drives both
    packages' states in ``tests/test_torch_interval_cache.py``.
    """

    policy = "lru"

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self.used = 0
        self.n_live = 0
        self._objs: dict[int, list] = {}     # recency map buckets
        self._sizes: dict[int, list] = {}    # size map buckets
        # per-object upper bound on covered keys (never lowered by
        # evictions): lets peer lookups skip objects/live tails this cache
        # cannot possibly hold without walking its segment lists
        self.obj_hi: dict[int, int] = {}
        # live chunk count per record id: lets the eviction scan skip fully
        # stale FIFO records in O(1) instead of re-walking segment lists
        self._rid_live: dict[int, int] = {}
        # per-object memo of the size map as numpy arrays — the fused block
        # replay's presence snapshot.  Hits never touch the size map, so the
        # memo survives the hot path; any size-map splice drops the entry
        self._zmemo: dict[int, tuple] = {}
        self._fifo: collections.deque = collections.deque()
        self._next_rid = 1
        # speculative eviction plan (EvictPlan) — dropped by any mutation
        # that could touch a planned victim run
        self._plan: "EvictPlan | None" = None
        # counters (CacheStats-compatible)
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.miss_bytes = 0
        self.evictions = 0
        self.inserted_bytes = 0

    # -- introspection -------------------------------------------------------

    def intervals(self) -> list[tuple[int, int]]:
        """Cached coverage as merged sorted disjoint ``[start, end)`` key
        runs (adjacent segments coalesced regardless of recency)."""
        out: list[tuple[int, int]] = []
        for obj in sorted(self._objs):
            ss, se, _ = self._objs[obj]
            for s, e in zip(ss, se):
                if out and out[-1][1] == s:
                    out[-1] = (out[-1][0], e)
                else:
                    out.append((s, e))
        return out

    def __contains__(self, key: int) -> bool:
        for ss, se, _ in self._objs.values():
            i = bisect.bisect_right(ss, key) - 1
            if i >= 0 and key < se[i]:
                return True
        return False

    def to_cache_stats(self) -> CacheStats:
        return CacheStats(self.hits, self.misses, self.hit_bytes,
                          self.miss_bytes, self.evictions, self.inserted_bytes)

    def check_invariants(self) -> None:
        """Test hook: both maps sorted, disjoint, covering the same chunks,
        and consistent with ``used``/``n_live``."""
        live = 0
        for obj, (ss, se, _) in self._objs.items():
            prev = None
            for s, e in zip(ss, se):
                assert s < e, (s, e)
                if prev is not None:
                    assert s >= prev, (s, prev)
                prev = e
                live += e - s
        used = zlive = 0
        for obj, (zs, ze, zz) in self._sizes.items():
            prev = None
            for s, e, z in zip(zs, ze, zz):
                assert s < e, (s, e)
                if prev is not None:
                    assert s >= prev, (s, prev)
                prev = e
                used += (e - s) * z
                zlive += e - s
        assert live == zlive == self.n_live, (live, zlive, self.n_live)
        assert used == self.used, (used, self.used)
        by_rid: dict[int, int] = {}
        for ss, se, sr in self._objs.values():
            for s, e, r in zip(ss, se, sr):
                by_rid[r] = by_rid.get(r, 0) + (e - s)
        assert by_rid == self._rid_live, (by_rid, self._rid_live)

    # -- segment-map plumbing ------------------------------------------------

    @staticmethod
    def _overlap_start(ss: list, se: list, lo: int) -> int:
        """Index of the first segment with ``end > lo``."""
        i = bisect.bisect_right(ss, lo) - 1
        if i < 0:
            return 0
        return i if se[i] > lo else i + 1

    def _splice_r(self, m: list, lo: int, hi: int, mid: "list | None") -> None:
        """Replace ``[lo, hi)`` of a recency map with ``mid`` (a
        ``[starts, ends, rids]`` triple, ownership transferred, or None),
        keeping the left/right remainders of the boundary segments
        (splitting them when the range cuts into them).  Maintains the
        per-record live-chunk counts that make stale-record detection O(1)
        in the eviction scan."""
        ss, se, sr = m
        i = self._overlap_start(ss, se, lo)
        j = i
        n = len(ss)
        live = self._rid_live
        while j < n and ss[j] < hi:
            a = ss[j] if ss[j] > lo else lo
            b = se[j] if se[j] < hi else hi
            r = sr[j]
            c = live[r] - (b - a)
            if c:
                live[r] = c
            else:
                del live[r]
            j += 1
        if mid is None:
            new_s, new_e, new_r = [], [], []
        else:
            new_s, new_e, new_r = mid
            for a, b, r in zip(new_s, new_e, new_r):
                live[r] = live.get(r, 0) + (b - a)
        if j > i and ss[i] < lo:                       # left remainder
            new_s.insert(0, ss[i]); new_e.insert(0, lo)
            new_r.insert(0, sr[i])
        if j > i and se[j - 1] > hi:                   # right remainder
            new_s.append(hi); new_e.append(se[j - 1])
            new_r.append(sr[j - 1])
        ss[i:j] = new_s; se[i:j] = new_e; sr[i:j] = new_r

    @staticmethod
    def _splice_z(m: list, lo: int, hi: int, mid: "list | None") -> None:
        """Replace ``[lo, hi)`` of a size map with ``mid`` (ownership
        transferred, or None), keeping boundary-segment remainders.

        Abutting equal-size runs are coalesced: the eviction scan's
        per-run ceil arithmetic is invariant under merging runs of the
        same chunk size (consuming ``[a,b)+[b,c)`` front-to-back equals
        consuming ``[a,c)``), and per-object chunk sizes rarely change,
        so coalescing keeps the map at O(distinct sizes) runs instead of
        one run per insert."""
        ss, se, sv = m
        i = IntervalLRUState._overlap_start(ss, se, lo)
        j = i
        n = len(ss)
        while j < n and ss[j] < hi:
            j += 1
        new_s, new_e, new_v = mid if mid is not None else ([], [], [])
        if j > i and ss[i] < lo:
            new_s.insert(0, ss[i]); new_e.insert(0, lo)
            new_v.insert(0, sv[i])
        if j > i and se[j - 1] > hi:
            new_s.append(hi); new_e.append(se[j - 1])
            new_v.append(sv[j - 1])
        k = 1
        while k < len(new_s):
            if new_s[k] == new_e[k - 1] and new_v[k] == new_v[k - 1]:
                new_e[k - 1] = new_e[k]
                del new_s[k], new_e[k], new_v[k]
            else:
                k += 1
        if new_s:
            if i > 0 and se[i - 1] == new_s[0] and sv[i - 1] == new_v[0]:
                new_s[0] = ss[i - 1]
                i -= 1
            if j < n and ss[j] == new_e[-1] and sv[j] == new_v[-1]:
                new_e[-1] = se[j]
                j += 1
        ss[i:j] = new_s; se[i:j] = new_e; sv[i:j] = new_v

    def _valid_segs(self, rid: int, obj: int, lo: int,
                    hi: int) -> list[tuple[int, int]]:
        """Sub-segments of ``[lo, hi)`` still carrying ``rid`` (the record's
        live chunks), ascending."""
        ss, se, sr = self._objs[obj]
        out = []
        i = self._overlap_start(ss, se, lo)
        n = len(ss)
        while i < n and ss[i] < hi:
            if sr[i] == rid:
                out.append((max(ss[i], lo), min(se[i], hi)))
            i += 1
        return out

    # -- eviction ------------------------------------------------------------

    def _evict_until(self, size: int, t_now: int) -> None:
        """Evict chunks in exact LRU order until ``used + size`` fits.
        Mirrors the reference's one-chunk-at-a-time loop arithmetically:
        per victim size run, evict ``ceil(shortfall / chunk_size)`` chunks."""
        self._plan = None          # deque pops invalidate scan positions
        fifo = self._fifo
        live = self._rid_live
        while self.used + size > self.capacity:
            rec = fifo.popleft()        # IndexError here would correspond to
            rid = rec[0]                # the reference's evict-from-empty
            if rid not in live:
                continue                # fully stale record: O(1) skip
            _, obj, lo, hi, src = rec
            self._zmemo.pop(obj, None)
            segs = self._valid_segs(rid, obj, lo, hi)
            stopped_at = None
            zmap = self._sizes[obj]
            zs, ze, zz = zmap
            rmap = self._objs[obj]
            for s, e in segs:
                # consume this presence run front-to-back, walking the size
                # runs beneath it (sizes vary at request boundaries)
                stop = s
                zi = self._overlap_start(zs, ze, s)
                while stop < e:
                    need = self.used + size - self.capacity
                    if need <= 0:
                        break
                    z = zz[zi]
                    pe = ze[zi] if ze[zi] < e else e
                    take = min(pe - stop, -(-need // z))
                    self.used -= take * z
                    stop += take
                    zi += 1 if stop == pe else 0
                if stop > s:
                    n_ev = stop - s
                    self.n_live -= n_ev
                    self.evictions += n_ev
                    self._splice_r(rmap, s, stop, None)
                    self._splice_z(zmap, s, stop, None)
                if stop < e:
                    stopped_at = stop
                    break
            if stopped_at is not None:
                # record only partially consumed: re-queue the remainder at
                # the head (it is still the oldest recency)
                fifo.appendleft((rid, obj, stopped_at, hi, src))
                return

    # -- bulk block APIs (fused block-over-intervals replay) -----------------

    def coverage_arrays(self, objs=None) -> tuple[np.ndarray, np.ndarray]:
        """Presence snapshot as flat globally sorted ``(starts, ends)``
        int64 arrays (each object owns a disjoint dense key span, so
        per-object concatenation in object order is globally sorted).  The
        fused block replay cuts its elementary intervals at these
        boundaries and stabs them for block-start presence.

        Reads the *size map*, not the recency map: both cover the same key
        set at all times (inserts and evictions splice identical ranges
        into both; hits only re-stamp recency), but size runs stay coarse —
        they never fragment per touch — and mutate only on insert/evict,
        so the per-object numpy conversion memo (``_zmemo``) survives the
        hit-dominated hot path.

        ``objs`` (sorted unique object ids) restricts the snapshot to those
        objects — exact for any query range inside their key spans (spans
        are disjoint, so no other object's runs can overlap), and the cost
        drops from the whole cache to the touched objects only."""
        zm = self._sizes
        memo = self._zmemo
        it = sorted(zm) if objs is None else objs
        ss_l: list = []
        ee_l: list = []
        for obj in it:
            got = memo.get(obj)
            if got is None:
                m = zm.get(obj)
                if m is None or not m[0]:
                    continue
                got = memo[obj] = (np.asarray(m[0], np.int64),
                                   np.asarray(m[1], np.int64))
            ss_l.append(got[0])
            ee_l.append(got[1])
        if not ss_l:
            z = np.empty(0, np.int64)
            return z, z
        if len(ss_l) == 1:
            return ss_l[0], ee_l[0]
        return np.concatenate(ss_l), np.concatenate(ee_l)

    def _plan_seg_bytes(self, obj: int, s: int, stop: int) -> int:
        """Bytes of the present run ``[s, stop)`` of ``obj`` (size-map
        walk; the run is fully covered)."""
        zs, ze, zz = self._sizes[obj]
        zi = self._overlap_start(zs, ze, s)
        freed = 0
        p = s
        while p < stop:
            pe = ze[zi] if ze[zi] < stop else stop
            freed += (pe - p) * zz[zi]
            p = pe
            zi += 1
        return freed

    def get_evict_plan(self, max_need: int) -> "EvictPlan":
        """The state's speculative eviction plan (see :class:`EvictPlan`),
        guaranteed to either cover ``>= max_need`` bytes or be exhausted.
        A cached plan is reused when it still meets that bar; the list
        state rebuilds otherwise (no incremental extension — deque scan
        positions are not stable enough to resume from)."""
        p = self._plan
        if p is not None and (p.total >= max_need or
                              (p.exhausted and
                               len(self._fifo) == p.flen)):
            return p
        vs_l: list[int] = []
        ve_l: list[int] = []
        vobj_l: list[int] = []
        segb_l: list[int] = []
        total = 0
        target = 2 * max_need
        exhausted = True
        for rec in self._fifo:
            if total >= target:
                exhausted = False
                break
            rid, obj, lo, hi, _src = rec
            if rid not in self._rid_live:
                continue
            for s, e in self._valid_segs(rid, obj, lo, hi):
                b = self._plan_seg_bytes(obj, s, e)
                vs_l.append(s)
                ve_l.append(e)
                vobj_l.append(obj)
                segb_l.append(b)
                total += b
        p = EvictPlan(self)
        p.vs = np.asarray(vs_l, np.int64)
        p.ve = np.asarray(ve_l, np.int64)
        p.vobj = np.asarray(vobj_l, np.int64)
        p.segb = np.asarray(segb_l, np.int64)
        p.cumb = p.segb.cumsum()
        p.total = total
        p.exhausted = exhausted
        p.flen = len(self._fifo)
        p._index()
        self._plan = p
        return p

    def plan_evict_clean(self, max_need: int, blocked_starts: list,
                         blocked_ends: list) -> int:
        """Dry-run the eviction scan: bytes freeable in exact LRU order
        before the first victim chunk inside a *blocked* run (sorted
        disjoint key runs), clamped at ``max_need`` — the last scanned run
        is consumed whole, so without the clamp the tally could overshoot
        the cap mid-run and leak scan-order detail into the result.  Pure —
        answered from the state's speculative :class:`EvictPlan`, which
        persists across calls (block truncations re-query with shrinking
        needs, and the scan is the thrash-regime floor).  The fused block
        replay uses the result to truncate a block so that its committed
        inserts can never evict a key the block itself references (which
        keeps the block-start snapshot valid for every in-block hit, dup
        and peer decision); it only ever compares the result against the
        shortfall ``max_need``, so the clamp is contract-neutral at that
        call site."""
        max_need = int(max_need)
        if max_need <= 0:
            return 0
        return self.get_evict_plan(max_need).clean_before(
            max_need, blocked_starts, blocked_ends)

    def commit_block(self, size_recs: list, recency_recs: list,
                     r_grp: "list | None" = None) -> None:
        """Bulk-commit one fused replay block.

        ``size_recs``: ``(obj, lo, hi, req_pos, size)`` insert runs merged
        per *inserting* (first-toucher) request, in trace order — they
        carry presence bookkeeping: size map, ``used``/``n_live``/
        ``inserted_bytes`` and ``obj_hi``.

        ``recency_recs``: ``(obj, lo, hi, src)`` runs merged per final
        stamp, ordered by (last-touching request, hit/peer/origin phase,
        ascending key) — exactly the reference's per-chunk final recency
        order, so appending them as FIFO records reproduces its LRU order.
        ``src`` is the last toucher's position for its own single-touch
        inserts and ``-1`` for re-touches, mirroring ``lookup_touch`` /
        ``insert_runs``.  Equivalent to replaying the block's requests one
        by one because only each chunk's *final* stamp is observable: the
        caller truncates blocks so no in-block key is evicted mid-block,
        and intermediate stamps of multiply-touched chunks are therefore
        never consulted.

        ``r_grp`` (optional): group ids, parallel to
        ``recency_recs``, contiguous and non-decreasing — records in one
        group (same DTN-object group, consecutive final stamps, ascending
        disjoint key runs) are fused under ONE record id and ONE FIFO
        record spanning first-lo..last-hi.  Exact because (a) a record's
        valid runs are consumed in ascending key order, which equals
        popping the per-run records consecutively, (b) the fused records
        occupy the same relative FIFO positions, and (c) keys in the gaps
        between a group's runs carry other rids and are filtered out by
        rid validity wherever the record is consulted."""
        oh = self.obj_hi
        objs = self._objs
        sizes = self._sizes
        zmemo = self._zmemo
        p = self._plan
        if p is not None:
            for obj, a, b, _src in recency_recs:
                if p.overlaps(a, b):
                    self._plan = None   # re-touch of a planned victim
                    break
        for obj, a, b, src, size in size_recs:
            zmemo.pop(obj, None)
            zmap = sizes.get(obj)
            if zmap is None:
                objs[obj] = [[], [], []]
                zmap = sizes[obj] = [[], [], []]
            self._splice_z(zmap, a, b, ([a], [b], [size]))
            nm = b - a
            self.used += nm * size
            self.n_live += nm
            self.inserted_bytes += nm * size
            if b > oh.get(obj, 0):
                oh[obj] = b
        fifo = self._fifo
        if r_grp is None:
            for obj, a, b, src in recency_recs:
                rid = self._next_rid
                self._next_rid = rid + 1
                fifo.append((rid, obj, a, b, src))
                self._splice_r(objs[obj], a, b, [[a], [b], [rid]])
            return
        k = 0
        n = len(recency_recs)
        while k < n:
            g = r_grp[k]
            j = k + 1
            while j < n and r_grp[j] == g:
                j += 1
            rid = self._next_rid
            self._next_rid = rid + 1
            obj, a0, b0, src0 = recency_recs[k]
            hi_last = recency_recs[j - 1][2]
            src = src0 if j == k + 1 else -1
            fifo.append((rid, obj, a0, hi_last, src))
            m = objs[obj]
            for _o, a, b, _s in recency_recs[k:j]:
                self._splice_r(m, a, b, [[a], [b], [rid]])
            k = j

    # -- serving -------------------------------------------------------------

    def lookup_touch(self, obj: int, lo: int, hi: int,
                     size: int) -> tuple[int, tuple]:
        """Hit/miss split plus LRU touch of the hits for chunk keys
        ``[lo, hi)`` of ``obj`` — the reference's per-chunk ``lookup`` loop
        in range form (hits touched in ascending chunk order, one coalesced
        record per maximal present run).  Returns ``(n_hits, miss_runs)``;
        the caller decides each miss run's source and inserts via
        :meth:`insert_runs` (peer-fetched ranges before origin ranges, the
        reference's order)."""
        if hi <= lo:
            return 0, ()
        p = self._plan
        if p is not None and p.overlaps(lo, hi):
            self._plan = None      # touch may re-stamp a planned victim
        m = self._objs.get(obj)
        if m is None:
            m = self._objs[obj] = [[], [], []]
            self._sizes[obj] = [[], [], []]
        ss, se, sr = m
        i = self._overlap_start(ss, se, lo)
        # fast path: full hit inside one segment — the dominant case for
        # the paper's moving-window traffic (coalescing keeps whole covered
        # windows in a single segment)
        if i < len(ss) and ss[i] <= lo and se[i] >= hi:
            nh = hi - lo
            self.hits += nh
            self.hit_bytes += nh * size
            live = self._rid_live
            fifo = self._fifo
            old = sr[i]
            if ss[i] == lo and se[i] == hi:
                if fifo and fifo[-1][0] == old and live[old] == nh:
                    # the segment IS the newest record, fully live:
                    # re-touching leaves the LRU order bit-identical
                    return nh, ()
                rid = self._next_rid
                self._next_rid = rid + 1
                fifo.append((rid, obj, lo, hi, -1))
                c = live[old] - nh
                if c:
                    live[old] = c
                else:
                    del live[old]
                live[rid] = nh
                sr[i] = rid
                return nh, ()
            rid = self._next_rid
            self._next_rid = rid + 1
            fifo.append((rid, obj, lo, hi, -1))
            c = live[old] - nh
            if c:
                live[old] = c
            else:
                del live[old]
            live[rid] = nh
            new_s, new_e, new_r = [lo], [hi], [rid]
            if ss[i] < lo:
                new_s.insert(0, ss[i]); new_e.insert(0, lo)
                new_r.insert(0, old)
            if se[i] > hi:
                new_s.append(hi); new_e.append(se[i])
                new_r.append(old)
            ss[i:i + 1] = new_s; se[i:i + 1] = new_e; sr[i:i + 1] = new_r
            return nh, ()
        # walk overlapped segments once: maximal present runs and gaps
        hit_runs: list[tuple[int, int]] = []
        miss_runs: list[tuple[int, int]] = []
        j = i
        n = len(ss)
        pos = lo
        while j < n and ss[j] < hi:
            a = ss[j] if ss[j] > lo else lo
            b = se[j] if se[j] < hi else hi
            if a > pos:
                miss_runs.append((pos, a))
            if hit_runs and hit_runs[-1][1] == a:
                hit_runs[-1] = (hit_runs[-1][0], b)
            else:
                hit_runs.append((a, b))
            pos = b
            j += 1
        if pos < hi:
            miss_runs.append((pos, hi))
        nh = (hi - lo) - sum(b - a for a, b in miss_runs)
        nm = (hi - lo) - nh
        self.hits += nh
        self.misses += nm
        self.hit_bytes += nh * size
        self.miss_bytes += nm * size
        # touch: one coalesced record per maximal hit run, ascending;
        # committed in a single splice of [lo, hi) (the miss gaps between
        # the runs simply stay gaps)
        if hit_runs:
            fifo = self._fifo
            h_s, h_e, h_r = [], [], []
            for a, b in hit_runs:
                rid = self._next_rid
                self._next_rid = rid + 1
                fifo.append((rid, obj, a, b, -1))
                h_s.append(a); h_e.append(b); h_r.append(rid)
            self._splice_r(m, lo, hi, [h_s, h_e, h_r])
        return nh, miss_runs

    def coverage_runs(self, obj: int, lo: int, hi: int) -> list:
        """Present sub-runs of ``[lo, hi)`` for ``obj`` (merged, ascending)
        — the peer-lookup primitive: one interval intersection instead of
        per-chunk membership tests."""
        if lo >= self.obj_hi.get(obj, 0):
            return []
        m = self._objs.get(obj)
        if m is None:
            return []
        ss, se, _ = m
        i = self._overlap_start(ss, se, lo)
        out: list[tuple[int, int]] = []
        n = len(ss)
        while i < n and ss[i] < hi:
            a = ss[i] if ss[i] > lo else lo
            b = se[i] if se[i] < hi else hi
            if out and out[-1][1] == a:
                out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
            i += 1
        return out

    def insert_runs(self, obj: int, runs: list, size: int,
                    req_pos: int) -> None:
        """Insert absent chunk runs (ascending) with reference ``insert``
        semantics: oversized chunks are skipped silently, eviction happens
        chunk by chunk ahead of each insertion, one FIFO record per
        inserted piece (so recency ascends with chunk id across the runs,
        exactly the reference's ascending insert loop)."""
        if not runs or size > self.capacity:
            return
        nm = sum(b - a for a, b in runs)
        oh = self.obj_hi
        if runs[-1][1] > oh.get(obj, 0):
            oh[obj] = runs[-1][1]
        self._zmemo.pop(obj, None)
        if self.used + nm * size <= self.capacity:
            fifo = self._fifo
            m = self._objs[obj]
            zmap = self._sizes[obj]
            for a, b in runs:
                rid = self._next_rid
                self._next_rid = rid + 1
                fifo.append((rid, obj, a, b, req_pos))
                self._splice_r(m, a, b, [[a], [b], [rid]])
                self._splice_z(zmap, a, b, ([a], [b], [size]))
            self.used += nm * size
            self.n_live += nm
            self.inserted_bytes += nm * size
            return
        self._insert_with_evict(obj, runs, size, req_pos)

    def serve(self, req_pos: int, obj: int, lo: int, hi: int,
              size: int) -> int:
        """Serve one request with every miss inserted in ascending chunk
        order (all from one source).  Returns the hit count."""
        nh, miss_runs = self.lookup_touch(obj, lo, hi, size)
        if miss_runs:
            self.insert_runs(obj, miss_runs, size, req_pos)
        return nh

    def _insert_with_evict(self, obj: int, miss_runs: list, size: int,
                           req_pos: int) -> None:
        """Insert miss runs chunk-group-wise, evicting ahead of each group —
        the reference's per-chunk evict-then-insert loop in range form.
        Runs after the hit touches so the request's own hits are already
        protected by fresh rids."""
        fifo = self._fifo
        for a, b in miss_runs:
            j = a
            while j < b:
                if self.used + size > self.capacity:
                    self._evict_until(size, req_pos)
                cnt = min(b - j, (self.capacity - self.used) // size)
                rid = self._next_rid
                self._next_rid = rid + 1
                self._splice_r(self._objs[obj], j, j + cnt,
                               [[j], [j + cnt], [rid]])
                self._splice_z(self._sizes[obj], j, j + cnt,
                               ([j], [j + cnt], [size]))
                fifo.append((rid, obj, j, j + cnt, req_pos))
                self.used += cnt * size
                self.n_live += cnt
                self.inserted_bytes += cnt * size
                j += cnt
