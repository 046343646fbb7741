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

