"""Vectorized batch-replay engine for the VDC simulator.

:class:`repro_torch.core.simulator.VDCSimulator` is the readable reference: every
chunk of every request walks through per-key Python dict/heap operations.
That caps replay at a few thousand requests/second — far from the paper's
17.9M-request (OOI) and 77.8M-request (GAGE) traces (§V-A1).

This module replays the same discrete-event semantics on array state:

- chunk ranges for the *whole* trace are precomputed in bulk
  (:func:`repro_torch.core.cache.chunk_bounds_bulk`);
- each DTN cache is an :class:`repro_torch.core.cache.IntCacheState` — presence,
  recency and sizes in flat NumPy arrays keyed by dense chunk ids
  ``obj * span + chunk + offset``, with batch touch/insert/evict;
- presence of all DTNs lives in one ``[n_dtn, n_keys]`` matrix so peer
  lookups (paper §IV-D resolution order) gather across every cache at once;
- strategies with no dynamic events (no_cache / cache_only) skip the event
  heap entirely and replay in *blocks*: a vectorized membership pass finds
  the longest all-hit prefix, which is retired with a handful of NumPy ops,
  and only the first missing request falls back to the per-request path;
- strategies with prefetch/streaming/placement (md1 / md2 / hpm) keep exact
  event ordering by merging the pre-sorted request arrays with a small heap
  of dynamic events, serving each event on chunk-id arrays.

Result equivalence with the reference engine is part of the contract (and
covered by ``tests/test_torch_engine.py``): identical integer counters
(origin requests, hits/misses/evictions, prefetch issue/use, byte splits)
and float aggregates equal to within summation-order rounding.  The same
prefetcher / streaming / placement model classes are used by both engines;
prefetchers that support batch planning (hpm) are pre-planned through the
two-phase planner here (``SimConfig.batched_prediction``), whose op stream
is bitwise identical to the online ``observe`` loop the reference replays
(``tests/test_torch_hpm.py``).

Only the vector engine is ported so far; the JAX package's interval engine
(``IntervalVDCSimulator`` and its presence timeline) is queued in ROADMAP.
"""
from __future__ import annotations

import collections
import collections.abc
import heapq
import itertools
import math
from typing import Sequence

import numpy as np

from repro_torch.core.cache import (CacheStats, chunk_bytes, chunk_bounds_bulk,
                                    make_int_cache_state)
from repro_torch.core.delivery import select_peer_sources
from repro_torch.core.hpm import PrefetchOp
from repro_torch.core.placement import PlacementEngine
from repro_torch.core.simulator import (DEFAULT_BANDWIDTH_GBPS, GBPS,
                                        USER_LINK_GBPS, OutcomeAggregate,
                                        RequestOutcome, SimConfig, SimResult)
from repro_torch.core.trace import (ObjectGrid, Request,
                                    StreamingRequestSource,
                                    requests_to_arrays)


class _LazyOutcomes(collections.abc.Sequence):
    """List-like over the engine's outcome columns; materializes the
    :class:`RequestOutcome` tuples on first element access so callers that
    only read aggregate counters never pay for construction."""

    __slots__ = ("_cols", "_n", "_data")

    def __init__(self, cols: tuple):
        self._cols = cols
        self._n = int(cols[0].shape[0])
        self._data: list | None = None

    def _materialize(self) -> list:
        if self._data is None:
            self._data = list(map(RequestOutcome._make,
                                  zip(*(c.tolist() for c in self._cols))))
            self._cols = ()
        return self._data

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())


def origin_submit(free_at: list, overhead: float, now: float,
                  duration: float) -> tuple[float, float]:
    """One origin-queue submission — THE scalar definition of the queue's
    float arithmetic and tie-breaking (first free process wins), shared by
    every replay loop so the cross-engine latency columns stay bit-exact
    against ``simulator._OriginQueue``.  Mutates ``free_at`` in place."""
    m = min(free_at)
    i = free_at.index(m)
    start = (now if now > m else m) + overhead
    end = start + duration
    free_at[i] = end
    return start, end


# hard cap on committed phases per block: each boundary pays an
# O(suffix) key merge + plan, so past this the block ends cleanly and
# the next block (adaptively resized) picks up where it left off
_FUSED_PHASE_MAX = 64


class _FastOriginQueue:
    """Origin task queue with the same float arithmetic and tie-breaking as
    ``simulator._OriginQueue`` (first free process wins), minus the per-call
    NumPy dispatch."""

    __slots__ = ("free_at", "overhead")

    def __init__(self, n_procs: int, overhead: float):
        self.free_at = [0.0] * n_procs
        self.overhead = overhead

    def submit(self, now: float, duration: float,
               with_overhead: bool = True) -> tuple[float, float]:
        return origin_submit(self.free_at,
                             self.overhead if with_overhead else 0.0,
                             now, duration)


class VectorVDCSimulator:
    """Replay a trace through the delivery framework on array-backed state.

    Drop-in for :class:`repro_torch.core.simulator.VDCSimulator` (same constructor,
    same ``run`` signature and :class:`SimResult` output).  One instance
    replays one trace (the chunk-address space is sized from the trace).
    """

    def __init__(self, grid: ObjectGrid, prefetcher, config: SimConfig,
                 use_cache: bool = True, device=None):
        self.grid = grid
        self.pf = prefetcher
        self.cfg = config
        self.use_cache = use_cache
        bw = (config.bandwidth_gbps
              if config.bandwidth_gbps is not None else DEFAULT_BANDWIDTH_GBPS)
        self.bw = bw * config.bandwidth_scale * GBPS          # bytes/s
        self.n_dtn = self.bw.shape[0]
        self.origin = _FastOriginQueue(config.n_service_procs,
                                       config.origin_latency_s)
        self.placement = (PlacementEngine(grid, device=device)
                          if config.enable_placement else None)
        self._chunk_bytes = chunk_bytes(config.stream_rate_bytes_per_s,
                                        config.chunk_seconds)
        self._user_dtn: dict[int, int] = {}
        self._recent_requests: collections.deque[Request] = collections.deque(
            maxlen=5000)
        self._last_placement_ts = 0.0
        self._ulink = USER_LINK_GBPS * GBPS
        self._bw0 = [float(self.bw[0, d]) for d in range(self.n_dtn)]
        self._bw0a = np.array(self._bw0)
        self._bw_l = self.bw.tolist()
        # chunk-address space (set up in run())
        self._off = 0
        self._span = 1
        self._n_keys = 0
        self.caches: dict[int, object] = {}
        self._present2d: np.ndarray | None = None
        self._pref2d: np.ndarray | None = None
        self._pref_issued = 0
        self._pref_used = 0
        # eviction-path telemetry: speculative plan calls,
        # blocks ended early at eviction pressure, scalar fallback serves,
        # committed mid-block phases, chunks evicted at mid-block boundaries
        self._ctr = {"plan": 0, "trunc": 0, "degen": 0,
                     "phases": 0, "invict": 0}
        # phased block replay: block sizing survives streamed window edges
        self._blk = 256
        self._degen = 0

    def _origin_dur(self, nbytes: float, dtn: int) -> float:
        """Origin-link wire time, with the reference's zero-bandwidth
        semantics (``_transfer_time``: non-positive link → inf)."""
        b = self._bw0[dtn]
        return nbytes / b if b > 0.0 else float("inf")

    # -- chunk addressing ----------------------------------------------------

    def _setup_address_space(self, first: np.ndarray, n: np.ndarray,
                             hint: tuple[int, int] | None = None) -> None:
        live = n > 0
        if live.any():
            lo = int(first[live].min())
            hi = int((first[live] + n[live]).max())
        else:
            lo, hi = 0, 1
        if hint is not None:
            # streaming sources declare their chunk extent up front so the
            # first window can size the space for the whole trace (widening
            # the span is a pure renaming of dense keys — see _run_stream)
            lo, hi = min(lo, hint[0]), max(hi, hint[1])
        self._off = max(0, -lo) + 8
        self._span = hi + self._off + 8
        self._alloc_state()

    def _alloc_state(self) -> None:
        n_keys = self.grid.n_objects * self._span
        self._n_keys = n_keys
        self._present2d = np.zeros((self.n_dtn, n_keys), np.bool_)
        self._present_flat = self._present2d.reshape(-1)
        self.caches = {
            d: make_int_cache_state(self.cfg.cache_policy, self.cfg.cache_bytes,
                                    n_keys, self._present2d[d])
            for d in range(1, self.n_dtn)
        }
        self._pref2d = np.zeros((self.n_dtn, n_keys), np.uint8)
        # per-key last in-block occurrence as a global monotone position:
        # one scatter per block; a key is still referenced at/after a phase
        # boundary s0 iff _blk_last[key] >= gbase + s0 (entries from older
        # blocks sit below gbase — no per-boundary sweep, no clearing)
        self._blk_last = np.zeros(n_keys, np.int64)
        self._blk_gpos = 1
        self._flat_dt = (np.int32 if self.n_dtn * n_keys < 2**31
                         else np.int64)

    def _grow(self, c_lo: int, c_hi: int) -> None:
        """Widen the per-object chunk span so [c_lo, c_hi] + old contents fit;
        re-keys every cache (a pure renaming, so replay state is unchanged)."""
        off_old, span_old = self._off, self._span
        off_new = max(off_old, -c_lo + 8)
        d_off = off_new - off_old
        span_new = max(span_old + d_off, c_hi + off_new + 8)
        span_new = span_new + span_new // 4              # headroom
        n_keys_new = self.grid.n_objects * span_new

        def mapper(keys: np.ndarray) -> np.ndarray:
            o, rc = np.divmod(keys, span_old)
            return o * span_new + rc + d_off

        present_new = np.zeros((self.n_dtn, n_keys_new), np.bool_)
        pref_new = np.zeros((self.n_dtn, n_keys_new), np.uint8)
        for d, cache in self.caches.items():
            cache.remap(mapper, n_keys_new, present_new[d])
            idx = np.nonzero(self._pref2d[d])[0]
            pref_new[d, mapper(idx)] = self._pref2d[d, idx]
        self._off, self._span, self._n_keys = off_new, span_new, n_keys_new
        self._present2d = present_new
        self._present_flat = present_new.reshape(-1)
        self._pref2d = pref_new
        self._blk_last = np.zeros(n_keys_new, np.int64)
        self._blk_gpos = 1                  # remap happens between blocks
        self._flat_dt = (np.int32 if self.n_dtn * n_keys_new < 2**31
                         else np.int64)
        # per-request base keys shift too
        self._base = self._obj_arr * span_new + self._first_arr + off_new

    def _encode_range(self, obj: int, c_first: int, c_last: int) -> np.ndarray:
        """Dense ids for chunks [c_first, c_last) of obj, growing on demand."""
        if c_first + self._off < 0 or c_last + self._off > self._span:
            self._grow(c_first, c_last)
        base = obj * self._span + self._off
        return np.arange(base + c_first, base + c_last, dtype=np.int64)

    # -- main entry ----------------------------------------------------------

    def run(self, requests: Sequence[Request], name: str = "") -> SimResult:
        if isinstance(requests, StreamingRequestSource):
            return self._run_stream(requests, name)
        arr = requests_to_arrays(requests)
        n_req = len(arr)
        A = self._prep_window(arr)
        stream_engine = getattr(self.pf, "streaming", None)
        static = (self.placement is None and stream_engine is None
                  and getattr(self.pf, "static", False))
        if static:
            self._run_static(A)
        else:
            self._run_dynamic(A, stream_engine)

        outcomes = _LazyOutcomes((
            A["now"], arr.user_id, self._o_bytes, self._o_lat, self._o_tra,
            self._o_loc, self._o_pref, self._o_peer, self._o_org,
            self._o_pt))
        if self.use_cache:
            stats = {d: c.to_cache_stats() for d, c in self.caches.items()}
        else:
            stats = {d: CacheStats() for d in range(1, self.n_dtn)}
        return SimResult(
            name=name or self.pf.name,
            outcomes=outcomes,
            origin_requests=int((self._o_org > 0).sum()),
            total_requests=n_req,
            prefetch_issued_chunks=self._pref_issued,
            prefetch_used_chunks=self._pref_used,
            cache_stats=stats,
            stream_pushes=stream_engine.pushes_emitted if stream_engine else 0,
            evict_plan_calls=self._ctr["plan"],
            block_truncations=self._ctr["trunc"],
            degenerate_serves=self._ctr["degen"],
            block_phases=self._ctr["phases"],
            inblock_victims=self._ctr["invict"],
        )

    def _prep_window(self, arr, hint: tuple[int, int] | None = None,
                     grow: bool = False) -> dict:
        """Per-trace (or per-window) request prep: chunk ranges, dense keys,
        scalar mirrors and the outcome SoA.  With ``grow=False`` the address
        space is sized from these requests (unioned with the chunk-extent
        ``hint`` when given); with ``grow=True`` the existing space and all
        cache state are kept, growing only if this window overflows it."""
        cfg = self.cfg
        n_req = len(arr)
        scale = 1.0 / cfg.traffic_scale
        now_arr = arr.ts * scale
        first, n_chunks = chunk_bounds_bulk(
            arr.tr_start, np.minimum(arr.tr_end, now_arr), cfg.chunk_seconds)
        # a request with no bytes (or no available chunks) never touches the
        # cache layer — exclude it from chunk batches entirely
        zero = (n_chunks == 0) | (arr.size_bytes == 0)
        k_eff = np.where(zero, 0, n_chunks)
        per_chunk = np.maximum(1, arr.size_bytes // np.maximum(1, n_chunks))
        dtn_arr = arr.continent + 1
        self._obj_arr = arr.obj
        self._first_arr = first
        if not grow:
            self._setup_address_space(first, k_eff, hint)
        else:
            live = k_eff > 0
            if live.any():
                lo = int(first[live].min())
                hi = int((first[live] + k_eff[live]).max())
                if lo + self._off < 0 or hi + self._off > self._span:
                    self._grow(lo, hi)
        self._base = arr.obj * self._span + first + self._off

        cap_min0 = min((c.capacity for c in self.caches.values()), default=0)
        self._pc_may_exceed_cap = bool(per_chunk.max(initial=0) > cap_min0)
        # fast scalar access for the per-event path
        self._k_arr = k_eff
        self._pc_arr = per_chunk
        self._k_l = k_eff.tolist()
        self._pc_l = per_chunk.tolist()
        self._zero_l = zero.tolist()
        # compact dtypes for the block path (smaller arrays, faster radix)
        self._base_k = self._base.astype(self._flat_dt)
        self._req32 = np.arange(n_req, dtype=np.int32)
        self._dtn32 = dtn_arr.astype(np.int32)
        self._bwcol = [self.bw[:, d].astype(np.float64)
                       for d in range(self.n_dtn)]

        # outcome SoA (filled in request-index order by both paths)
        self._o_lat = np.zeros(n_req, np.float64)
        self._o_tra = np.zeros(n_req, np.float64)
        self._o_pt = np.zeros(n_req, np.float64)
        self._o_loc = np.zeros(n_req, np.int64)
        self._o_pref = np.zeros(n_req, np.int64)
        self._o_peer = np.zeros(n_req, np.int64)
        self._o_org = np.zeros(n_req, np.int64)
        self._o_bytes = np.where(zero, 0, arr.size_bytes)
        return dict(now=now_arr, dtn=dtn_arr, k=k_eff, pc=per_chunk,
                    zero=zero, arr=arr)

    # -- streaming entry (windowed replay over a StreamingRequestSource) -----

    def _run_stream(self, source: StreamingRequestSource,
                    name: str = "") -> SimResult:
        """Windowed replay: identical per-request arithmetic and event order
        to :meth:`run` on the materialized trace, with only one window of
        requests resident at a time.

        Exactness: static block replay never depends on block extent (the
        truncation invariants hold for any boundary placement), so forcing
        block boundaries at window edges changes no counter.  The dynamic
        path keeps the event heap and its creation counter alive across
        windows; requests are never heaped, and the merged loop's strict
        ``event_ts < request_ts`` pop condition reproduces the materialized
        event order for any window split.  Batched prediction goes through
        the prefetcher's stateful window planner, whose op stream is
        window-split invariant (``tests/test_torch_hpm.py``).  Outcome
        columns are folded into an :class:`OutcomeAggregate` per window
        instead of a ``len(trace)`` outcome list, so peak memory is bounded
        by the window size plus the dense key space."""
        cfg = self.cfg
        stream_engine = getattr(self.pf, "streaming", None)
        static = (self.placement is None and stream_engine is None
                  and getattr(self.pf, "static", False))
        hint = None
        if source.tr_bounds is not None:
            cs = cfg.chunk_seconds
            hint = (int(math.floor(source.tr_bounds[0] / cs)),
                    int(math.ceil(source.tr_bounds[1] / cs)) + 1)
        agg = OutcomeAggregate()
        origin_requests = 0
        n_total = 0
        heap: list = []
        counter = itertools.count()   # orders dynamic events among themselves
        planner = None
        if not static and cfg.batched_prediction:
            planner_fn = getattr(self.pf, "planner", None)
            if planner_fn is not None:
                planner = planner_fn()
        first = True
        for window in source.windows():
            arr = requests_to_arrays(window)
            A = self._prep_window(arr, hint=hint, grow=not first)
            first = False
            if static:
                self._run_static(A)
            else:
                self._run_dyn_window(A, stream_engine, heap, counter, planner)
            agg.add_columns(self._o_bytes, self._o_lat, self._o_tra,
                            self._o_loc, self._o_pref, self._o_peer,
                            self._o_org, self._o_pt)
            origin_requests += int((self._o_org > 0).sum())
            n_total += len(arr)
        if first:
            # empty source: allocate the (empty) address space so cache
            # stats report per-DTN zeros exactly like an empty materialized
            # run
            self._prep_window(requests_to_arrays([]), hint=hint)
        if not static:
            self._dyn_drain(heap, stream_engine)
        if self.use_cache:
            stats = {d: c.to_cache_stats() for d, c in self.caches.items()}
        else:
            stats = {d: CacheStats() for d in range(1, self.n_dtn)}
        return SimResult(
            name=name or self.pf.name,
            outcomes=[],
            origin_requests=origin_requests,
            total_requests=n_total,
            prefetch_issued_chunks=self._pref_issued,
            prefetch_used_chunks=self._pref_used,
            cache_stats=stats,
            stream_pushes=stream_engine.pushes_emitted if stream_engine else 0,
            aggregate=agg,
            evict_plan_calls=self._ctr["plan"],
            block_truncations=self._ctr["trunc"],
            degenerate_serves=self._ctr["degen"],
            block_phases=self._ctr["phases"],
            inblock_victims=self._ctr["invict"],
        )

    # -- static fast path (no dynamic events) --------------------------------

    def _run_static(self, A: dict) -> None:
        if not self.use_cache:
            self._run_static_no_cache(A)
            return
        n_req = len(A["arr"])
        now_a, dtn_a, k_a, pc_a = A["now"], A["dtn"], A["k"], A["pc"]
        now_l, dtn_l = now_a.tolist(), dtn_a.tolist()
        lru = all(c.policy == "lru" for c in self.caches.values())
        if not lru:
            # LFU keeps a per-touch heap; replay per request (still far
            # cheaper than the reference's per-chunk dict walk)
            for idx in range(n_req):
                self._serve_event(idx, now_l[idx], dtn_l[idx], False, False)
            return
        # Block replay.  Invariant that makes whole blocks vectorizable with
        # misses *included*: in the static path every missed chunk is
        # inserted into the local DTN cache (peer or origin source), so a
        # chunk position is a true hit iff it hits the block-start snapshot
        # OR the same (dtn, chunk) occurred earlier in the block.  Blocks
        # under eviction pressure are replayed in PHASES: victims are
        # evicted at phase boundaries, and planning at a boundary blocks
        # every key referenced in the remaining suffix, so no still-queried
        # chunk is ever evicted and the classification stays exact for the
        # whole block.  Only origin-queue submits replay scalarly (their
        # state is sequential but tiny).
        n_keys = self._n_keys
        i = 0
        block = self._blk
        degenerate = self._degen
        while i < n_req:
            if degenerate >= 4:
                # cache-thrash regime (working set >> capacity): block
                # classification keeps getting invalidated by in-block
                # evictions, so replay a stretch per-request before retrying
                stop = min(i + 256, n_req)
                self._ctr["degen"] += stop - i
                while i < stop:
                    self._serve_event(i, now_l[i], dtn_l[i], False, False)
                    i += 1
                degenerate = 0
                block = 64
                continue
            j = min(i + block, n_req)
            kb = k_a[i:j]
            cum = kb.cumsum()
            ktot = int(cum[-1]) if len(cum) else 0
            if ktot > (1 << 22):
                # cap block chunk positions (rank encoding + memory)
                j = i + max(1, int(cum.searchsorted(1 << 22)))
                kb = kb[:j - i]
                cum = cum[:j - i]
                ktot = int(cum[-1])
            if ktot == 0:
                i = j
                block = min(65536, block * 2)
                continue
            starts = cum - kb
            kdt = self._flat_dt
            req_rep = self._req32[i:j].repeat(kb)
            keys = (np.arange(ktot, dtype=kdt)
                    + (self._base_k[i:j] - starts.astype(kdt)).repeat(kb))
            dtns = self._dtn32[req_rep]
            flat = dtns.astype(kdt, copy=False) * kdt(n_keys) + keys
            h0 = self._present_flat[flat]
            # same (dtn, chunk) seen earlier in the block?  One stable radix
            # argsort groups equal flat ids into runs; the first position of
            # each run is the first occurrence (commit reuses the same sort
            # for last occurrences / unique records).
            order_f = flat.argsort(kind="stable")
            sf = flat[order_f]
            newrun = np.empty(ktot, np.bool_)
            newrun[0] = True
            np.not_equal(sf[1:], sf[:-1], out=newrun[1:])
            dup = np.ones(ktot, np.bool_)
            dup[order_f[newrun]] = False
            true_hit = h0 | dup
            ins = ~true_hit
            # an insert larger than its cache is *skipped* by the
            # reference, breaking the duplicate-hit invariant → blocker
            b_big = j
            ins_pos_all = ins.nonzero()[0]
            if len(ins_pos_all) and self._pc_may_exceed_cap:
                cap_min = min(c.capacity for c in self.caches.values())
                too_big = (pc_a[i:j] > cap_min) & (kb > 0)
                if too_big.any():
                    b_big = i + int(np.argmax(too_big))
            # per-cache insert positions + cumulative bytes, block-level;
            # every phase boundary plans and applies against slices of them
            d_poss: dict[int, np.ndarray] = {}
            cum_inss: dict[int, np.ndarray] = {}
            m_all = len(ins_pos_all)
            ins_bytes_all = None
            if m_all:
                ins_d_all = dtns[ins_pos_all]
                ins_bytes_all = pc_a[req_rep[ins_pos_all]]
                for d in self.caches:
                    dm = ins_d_all == d
                    if dm.any():
                        d_poss[d] = ins_pos_all[dm]
                        cum_inss[d] = ins_bytes_all[dm].cumsum()
            # per-key last in-block occurrence, one scatter per block (the
            # ascending write order leaves the LAST position per key); a
            # key is referenced at/after boundary s0 iff its entry clears
            # gbase + s0 — replaces the per-boundary O(suffix) mark sweep
            gbase = self._blk_gpos
            self._blk_last[keys] = gbase + np.arange(ktot, dtype=np.int64)
            self._blk_gpos = gbase + ktot
            # block-level peer resolution against block-start presence:
            # exact for every phase because mid-block evictions only take
            # legal victims (no remaining in-block occurrence), so no
            # still-queried chunk loses its snapshot presence, and the
            # in-block first-missed union below covers earlier-phase
            # inserts the same way per-phase presence reads would
            acc_all = srcbw_all = ph_all = None
            if m_all:
                ph_all = np.zeros(ktot, np.int8)
                ph_all[ins_pos_all] = 2
                if self.cfg.enable_peer_cache and self.n_dtn > 1:
                    ik = keys[ins_pos_all]
                    idn = dtns[ins_pos_all]
                    ireq = req_rep[ins_pos_all]
                    iflat = flat[ins_pos_all]          # unique per (dtn, key)
                    so = iflat.argsort()
                    s_flat = iflat[so]
                    s_req = ireq[so]
                    ar = np.arange(m_all)
                    # score = link bandwidth if the peer holds the chunk
                    # else 0; argmax picks max-bw peer, lowest DTN id on
                    # ties (reference iterates DTNs ascending keeping
                    # strict improvements only — DTN 0 is the origin and
                    # never a peer, so only rows 1.. are scored); in-block
                    # earlier first-misses join via one batched
                    # searchsorted over all peer rows at once
                    ddv = np.arange(1, self.n_dtn, dtype=np.int64)
                    f2 = ddv[:, None] * self._n_keys + ik   # (D-1, m)
                    cand = self._present_flat[f2]
                    bwm = self.bw[1:, idn]                  # (D-1, m)
                    scores = cand * bwm
                    loc = s_flat.searchsorted(f2.reshape(-1)).reshape(f2.shape)
                    locc = np.minimum(loc, m_all - 1)
                    inb = ((loc < m_all) & (s_flat[locc] == f2)
                           & (s_req[locc] < ireq))
                    np.maximum(scores, inb * bwm, out=scores)
                    has1 = idn >= 1
                    scores[idn[has1] - 1, ar[has1]] = 0.0
                    src = np.argmax(scores, axis=0)
                    srcbw_all = scores[src, ar]
                    acc_all = srcbw_all > self.bw[0, idn]
                    ph_all[ins_pos_all[acc_all]] = 1

            def plan_b(r0: int):
                """Plan the phase starting at request ``r0``: evictions are
                allowed at the boundary as long as no victim's key is
                referenced in the remaining suffix (else hit/peer decisions
                would change).  Returns the furthest reachable request and
                the per-cache eviction plans — in-block victims (records
                committed by earlier phases whose keys fell out of the
                suffix) interleave into each plan in LRU stamp order."""
                b_next = b_big
                plans: list[tuple] = []
                if b_next == r0 or not d_poss:
                    return b_next, plans
                s0 = int(starts[r0 - i]) if r0 > i else 0
                thresh = gbase + s0
                for d, cache in self.caches.items():
                    d_pos = d_poss.get(d)
                    if d_pos is None:
                        continue
                    nin0 = int(d_pos.searchsorted(s0))
                    if nin0 == len(d_pos):
                        continue
                    cum_d = cum_inss[d]
                    base = int(cum_d[nin0 - 1]) if nin0 else 0
                    total = int(cum_d[-1]) - base
                    room = cache.capacity - cache.used
                    if total <= room:
                        continue
                    self._ctr["plan"] += 1
                    vk, cumf, ends = cache.plan_evictions_spec(
                        total - room, self._blk_last, thresh)
                    clean = int(cumf[-1]) if len(cumf) else 0
                    if clean + room < total:
                        over = cum_d[nin0:] - base > room + clean
                        pp = int(d_pos[nin0 + int(np.argmax(over))])
                        b_next = min(b_next, int(req_rep[pp]))
                    plans.append((cache, d_pos, cum_d, nin0, base, room,
                                  vk, cumf, ends))
                return b_next, plans

            r0 = i
            b_next, plans = plan_b(i)
            n_phase = 0
            blocked = b_next == i
            while not blocked:
                # evict at the boundary for this phase's inserts, then
                # commit the phase; both must land before the next
                # boundary's plan reads the cache (used bytes, LRU stamps)
                p0c = int(starts[r0 - i]) if r0 > i else 0
                p1c = ktot if b_next == j else int(starts[b_next - i])
                for (cache, d_pos, cum_d, nin0, base, room,
                     vk, cumf, ends) in plans:
                    nin = int(d_pos.searchsorted(p1c))
                    if nin <= nin0:
                        continue
                    need = int(cum_d[nin - 1]) - base - room
                    if need <= 0:
                        continue
                    n_ev = int(cumf.searchsorted(need)) + 1
                    ev0 = cache.evictions
                    cache.apply_evictions(vk, cumf, ends, n_ev)
                    if r0 > i:
                        self._ctr["invict"] += cache.evictions - ev0
                self._block_commit(r0, b_next, p0c, p1c, req_rep, keys,
                                   dtns, flat, true_hit, order_f, newrun,
                                   ph_all)
                n_phase += 1
                if r0 > i:
                    self._ctr["phases"] += 1
                r0 = b_next
                if r0 == j or n_phase >= _FUSED_PHASE_MAX:
                    # block done — or the per-boundary suffix work has been
                    # paid enough times: end the block cleanly at r0
                    break
                b_next, plans = plan_b(r0)
                blocked = b_next == r0
            if r0 > i:
                # per-request outcome + per-DTN stat accounting for every
                # committed phase, batched once per block (and before any
                # scalar serve of a blocker, preserving origin-queue order)
                p1c_f = ktot if r0 == j else int(starts[r0 - i])
                self._block_account(i, r0, p1c_f, ins_pos_all, ins_bytes_all,
                                    acc_all, srcbw_all, req_rep, dtns, now_a)
            if blocked:
                # the blocker request is served scalarly right away (exact
                # for oversize inserts and eviction pressure alike)
                self._ctr["trunc"] += 1
                self._ctr["degen"] += 1
                self._serve_event(r0, now_l[r0], dtn_l[r0], False, False)
                kept = r0 - i + 1
                block = min(65536, max(64, kept + (kept >> 2)))
                degenerate = degenerate + 1 if r0 - i < 8 else 0
                i = r0 + 1
            else:
                kept = r0 - i
                i = r0
                degenerate = 0
                if n_phase > 12:
                    # heavy phasing: each boundary pays an O(suffix) mark +
                    # plan, so size the next block to land near ~8 phases
                    block = min(65536, max(64, (kept * 8) // n_phase))
                else:
                    block = min(65536, block * 2)
        # adaptive sizing survives streamed window edges
        self._blk = block
        self._degen = degenerate

    def _block_commit(self, r0: int, b: int, P0: int, P1: int, req_rep,
                      keys, dtns, flat, true_hit, order_f, newrun,
                      ph_all) -> None:
        """Commit one phase's cache records — requests [r0, b), chunk
        positions [P0, P1) of the enclosing block.  Only cache state moves
        here; per-request outcome and per-DTN stat accounting is batched
        once per block in :meth:`_block_account` (block-level peer
        resolution feeds both, see the exactness note in ``_run_static``).

        The commit derives UNIQUE (dtn, key) records from a stable
        flat-id sort: each run of equal flat ids yields its first
        occurrence (insert decision + insert size) and last occurrence
        (final recency).  A key never repeats inside one request, so
        "last in reference order (hits, peer inserts, origin inserts per
        request)" == "last by position" — ranks encode that order and
        double as sparse LRU stamps (order matters, not contiguity).
        Successive phase commits stay monotone automatically:
        commit_unique advances the cache clock by ``rank_span`` per call."""
        if P1 == P0:
            return
        ktot = len(keys)
        R = b - r0
        pc_a = self._pc_arr
        if P0 == 0 and P1 == ktot:
            of, nr = order_f, newrun
        else:
            # re-sorting the phase slice beats filtering the block sort:
            # runs of equal flat ids restricted to [P0, P1) keep their
            # relative (stable) order either way
            of = P0 + flat[P0:P1].argsort(kind="stable")
            nr = np.empty(len(of), np.bool_)
            nr[0] = True
            sfp = flat[of]
            np.not_equal(sfp[1:], sfp[:-1], out=nr[1:])
        first_pos = of[nr]
        last_mask = np.empty(len(nr), np.bool_)
        last_mask[-1] = True
        last_mask[:-1] = nr[1:]
        last_pos = of[last_mask]
        u_dtn = dtns[first_pos]                 # (dtn, key)-sorted already
        u_keys = keys[first_pos]
        u_ins = ~true_hit[first_pos]
        u_sz = pc_a[req_rep[first_pos]]
        # ranks only materialize on the unique subset; a position's phase
        # class is 0 (hit) / 1 (accepted peer) / 2 (origin), read from the
        # block-level classification
        u_rank = (req_rep[last_pos].astype(np.int64) - r0) * 3
        if ph_all is not None:
            u_rank += ph_all[last_pos]
        u_rank = (u_rank << 22) + last_pos
        rank_span = (3 * R + 3) << 22
        # one composite (dtn, rank) sort orders every cache's slice at once
        # (u_rank < 2^45: rank ≤ 3·65536+2 shifted 22); per-DTN segments are
        # then contiguous views — no per-cache argsort or gather
        go = ((u_dtn.astype(np.int64) << 45) + u_rank).argsort()
        u_keys = u_keys[go]
        u_rank = u_rank[go]
        u_ins = u_ins[go]
        u_sz = u_sz[go]
        bounds = u_dtn.searchsorted(np.arange(self.n_dtn + 1))
        for d, cache in self.caches.items():
            s0, s1 = int(bounds[d]), int(bounds[d + 1])
            if s1 > s0:
                cache.commit_unique(u_keys[s0:s1], u_rank[s0:s1],
                                    u_ins[s0:s1], u_sz[s0:s1], rank_span)

    def _block_account(self, i: int, r_end: int, p1c: int, ins_pos_all,
                       ins_bytes_all, acc_all, srcbw_all, req_rep, dtns,
                       now_a) -> None:
        """Per-request outcome aggregation and per-DTN lookup stats for the
        committed request prefix [i, r_end) of one block — every committed
        phase at once.  Exact at block level because the inputs (insert
        set, peer accept/bandwidth) are themselves block-level and the
        origin loop visits origin-bound requests in ascending order, the
        same sequence the per-phase loops would concatenate to."""
        R = r_end - i
        pc_a = self._pc_arr
        ni = int(ins_pos_all.searchsorted(p1c)) if len(ins_pos_all) else 0
        if ni:
            ins_pos = ins_pos_all[:ni]
            ipc = ins_bytes_all[:ni]
            rel_ins = req_rep[ins_pos].astype(np.int64) - i
            acc = (acc_all[:ni] if acc_all is not None
                   else np.zeros(ni, np.bool_))
            # hits per request = k - misses, so only the (small) insert
            # set needs a bincount
            kb_r = np.bincount(rel_ins, minlength=R)
        else:
            kb_r = np.zeros(R, np.int64)
        n_hit_r = self._k_arr[i:r_end] - kb_r
        pc_r = pc_a[i:r_end]
        local_b_r = n_hit_r * pc_r
        tra = n_hit_r * (pc_r / self._ulink)
        if ni and acc.any():
            apc = ipc[acc]
            rel_acc = rel_ins[acc]
            peer_t_r = np.bincount(rel_acc, weights=apc / srcbw_all[:ni][acc],
                                   minlength=R)
            self._o_peer[i:r_end] = np.bincount(
                rel_acc, weights=apc, minlength=R).astype(np.int64)
            self._o_pt[i:r_end] = peer_t_r
            tra = tra + peer_t_r
        self._o_loc[i:r_end] = local_b_r
        if ni and not acc.all():
            # origin queue state is inherently sequential; replay just these
            # through the shared scalar submit (once per origin-bound
            # request of the whole trace), but batch every per-request
            # array read/write around the loop — only (start, end) pairs
            # are produced scalarly
            n_still_r = np.bincount(rel_ins[~acc], minlength=R)
            free = self.origin.free_at
            ov = self.origin.overhead
            submit = origin_submit
            rels = np.nonzero(n_still_r)[0]
            ridxs = i + rels
            obv = pc_r[rels] * n_still_r[rels]
            bbv = self._bw0a[self._dtn32[ridxs]]
            durv = np.full(len(rels), np.inf)
            # elementwise int64→float64 division matches the scalar
            # ``ob / bb`` bit-for-bit; inf stands in where bw is zero
            np.divide(obv, bbv, out=durv, where=bbv > 0.0)
            nowv = now_a[ridxs]
            starts = []
            ends = []
            for now, dur in zip(nowv.tolist(), durv.tolist()):
                s, e = submit(free, ov, now, dur)
                starts.append(s)
                ends.append(e)
            starts = np.array(starts)
            ends = np.array(ends)
            self._o_lat[ridxs] = starts - nowv
            tra[rels] += ends - starts
            self._o_org[ridxs] = obv
        self._o_tra[i:r_end] = tra
        # per-DTN lookup stats from per-request totals minus the insert set
        d_sl = self._dtn32[i:r_end]
        k_sl = self._k_arr[i:r_end]
        cnt_d = np.bincount(d_sl, weights=k_sl, minlength=self.n_dtn)
        pcs_d = np.bincount(d_sl, weights=k_sl * pc_a[i:r_end],
                            minlength=self.n_dtn)
        if ni:
            idn_all = dtns[ins_pos]
            mcnt_d = np.bincount(idn_all, minlength=self.n_dtn)
            mpcs_d = np.bincount(idn_all, weights=ipc,
                                 minlength=self.n_dtn)
        for d, cache in self.caches.items():
            nm_d = int(mcnt_d[d]) if ni else 0
            mb = int(mpcs_d[d]) if ni else 0
            cache.hits += int(cnt_d[d]) - nm_d
            cache.misses += nm_d
            cache.hit_bytes += int(pcs_d[d]) - mb
            cache.miss_bytes += mb

    def _run_static_no_cache(self, A: dict) -> None:
        submit = self.origin.submit
        origin_dur = self._origin_dur
        o_lat, o_tra, o_org = self._o_lat, self._o_tra, self._o_org
        zero_l = A["zero"].tolist()
        for idx, (now, d, k, pc) in enumerate(zip(
                A["now"].tolist(), A["dtn"].tolist(), A["k"].tolist(),
                A["pc"].tolist())):
            if zero_l[idx]:
                continue
            ob = pc * k
            start, end = submit(now, origin_dur(ob, d))
            o_lat[idx] = start - now
            o_tra[idx] = end - start
            o_org[idx] = ob

    # -- dynamic path (prefetch / streaming / placement events) --------------

    def _run_dynamic(self, A: dict, stream_engine) -> None:
        # batched prediction: prefetchers that expose a plan (hpm) have
        # their whole op stream pre-computed in two phases — classification
        # over per-user arrays, then ARIMA-bank kernel flush — instead of
        # per-request observe() calls inside the event loop.  The plan is
        # op-for-op identical to the online stream (the planner contract).
        # Only this mode materializes all scaled requests at once; the
        # online path keeps constructing them per event.
        plan = None
        reqs = None
        plan_fn = getattr(self.pf, "plan", None)
        if plan_fn is not None and self.cfg.batched_prediction:
            reqs = self._scaled_requests(A)
            plan = plan_fn(reqs)
        heap: list = []
        counter = itertools.count(len(A["arr"]))   # requests own 0..n-1
        self._dyn_loop(A, stream_engine, heap, counter, plan, reqs)
        self._dyn_drain(heap, stream_engine)

    def _run_dyn_window(self, A: dict, stream_engine, heap: list, counter,
                        planner) -> None:
        """One window of the streaming dynamic path: batch-plan this window
        through the stateful window planner (when available), then run the
        shared merged loop against the persistent event heap."""
        plan = reqs = None
        if planner is not None:
            reqs = self._scaled_requests(A)
            plan = planner.plan_window(reqs)
        self._dyn_loop(A, stream_engine, heap, counter, plan, reqs)

    def _scaled_requests(self, A: dict) -> list[Request]:
        arr = A["arr"]
        return list(map(Request, A["now"].tolist(), arr.user_id.tolist(),
                        arr.obj.tolist(), arr.tr_start.tolist(),
                        arr.tr_end.tolist(), arr.size_bytes.tolist(),
                        arr.continent.tolist()))

    def _dyn_drain(self, heap: list, stream_engine) -> None:
        while heap:
            t, _, kind, payload = heapq.heappop(heap)
            if kind == "s":
                if stream_engine is not None:
                    self._apply_push(payload)
            else:
                self._apply_prefetch(payload, t)

    def _dyn_loop(self, A: dict, stream_engine, heap: list, counter,
                  plan, reqs) -> None:
        arr = A["arr"]
        n_req = len(arr)
        cfg = self.cfg
        now_l = A["now"].tolist()
        dtn_l = A["dtn"].tolist()
        user_l = arr.user_id.tolist()
        obj_l = arr.obj.tolist()
        trs_l = arr.tr_start.tolist()
        tre_l = arr.tr_end.tolist()
        size_l = arr.size_bytes.tolist()
        cont_l = arr.continent.tolist()
        pf = self.pf
        placement = self.placement
        user_dtn = self._user_dtn
        i = 0
        while i < n_req:
            if heap and heap[0][0] < now_l[i]:
                t, _, kind, payload = heapq.heappop(heap)
                if kind == "s":
                    if stream_engine is not None:
                        self._apply_push(payload)
                else:
                    self._apply_prefetch(payload, t)
                continue
            idx = i
            i += 1
            now = now_l[idx]
            dtn = dtn_l[idx]
            r_scaled = (reqs[idx] if reqs is not None else
                        Request(now, user_l[idx], obj_l[idx], trs_l[idx],
                                tre_l[idx], size_l[idx], cont_l[idx]))
            user_dtn[r_scaled.user_id] = dtn
            self._recent_requests.append(r_scaled)
            absorbed = bool(stream_engine and stream_engine.absorb(r_scaled))
            self._serve_event(idx, now, dtn, absorbed, True)
            if plan is None:
                ops = pf.observe(r_scaled)
            else:
                ops = plan.ops[idx]
                for sub in plan.subscriptions[idx]:
                    stream_engine.subscribe(*sub)
            for op in ops:
                heapq.heappush(heap, (max(now, op.issue_ts), next(counter),
                                      "p", op))
            if stream_engine is not None:
                for push in stream_engine.pushes_until(now):
                    heapq.heappush(heap, (push.ts, next(counter), "s", push))
            if (placement is not None
                    and now - self._last_placement_ts >= cfg.placement_period):
                self._run_placement(now)
                self._last_placement_ts = now

    # -- serving -------------------------------------------------------------

    def _serve_event(self, idx: int, now: float, dtn: int, absorbed: bool,
                     track_pref: bool) -> None:
        """Reference ``VDCSimulator._serve`` on chunk-id arrays; fills the
        outcome SoA row for request ``idx``."""
        if self._zero_l[idx]:
            return                      # outcome row stays all-zero
        kk = self._k_l[idx]
        pc = self._pc_l[idx]
        lo = int(self._base[idx])
        hi = lo + kk
        cache = self.caches[dtn] if self.use_cache else None
        if cache is not None and kk <= 3 and cache.policy == "lru":
            # real-time polls and other tiny requests dominate the dynamic
            # (hpm) event loop; a scalar walk beats array dispatch here
            self._serve_event_scalar(idx, now, dtn, absorbed, track_pref,
                                     kk, pc, lo, hi, cache)
            return
        local_b = pref_b = peer_b = origin_b = 0
        transfer = 0.0
        latency = 0.0
        peer_t = 0.0
        miss_keys = None
        n_miss = kk
        if cache is not None:
            seg = self._present2d[dtn, lo:hi]
            nh = int(seg.sum())
            if nh:
                hit_keys = seg.nonzero()[0] + lo
                if track_pref:
                    prow = self._pref2d[dtn]
                    consume = hit_keys[prow[hit_keys] == 1]
                    nc = len(consume)
                    if nc:
                        prow[consume] = 2
                        self._pref_used += nc
                        pref_b = nc * pc
                    local_b = (nh - nc) * pc
                else:
                    local_b = nh * pc
                transfer += nh * (pc / self._ulink)
                cache.touch_hits(hit_keys)
            cache.record_lookup(nh, kk - nh, pc)
            n_miss = kk - nh
            if n_miss:
                miss_keys = (~seg).nonzero()[0] + lo
        # peer lookup for missing chunks (fetch iff the peer link beats the
        # origin's, same tie-breaking as the reference: lowest DTN id wins)
        if n_miss and self.cfg.enable_peer_cache and self.use_cache:
            bwcol = self._bwcol[dtn]
            cand = self._present2d[:, miss_keys].copy()
            cand[0] = False
            cand[dtn] = False
            src, acc = select_peer_sources(bwcol, cand)
            na = int(acc.sum())
            if na:
                peer_b = na * pc
                dts = float((pc / bwcol[src[acc]]).sum())
                transfer += dts
                peer_t += dts
                cache.insert_batch(miss_keys[acc], pc)
                still_keys = miss_keys[~acc]
                n_still = n_miss - na
            else:
                still_keys = miss_keys
                n_still = n_miss
        else:
            still_keys = miss_keys
            n_still = n_miss
        # origin for the rest (absorbed real-time polls skip the queue)
        if n_still:
            ob = pc * n_still
            if absorbed:
                transfer += ob / self._ulink
                local_b += ob
            else:
                origin_b = ob
                start, end = self.origin.submit(now, self._origin_dur(ob, dtn))
                latency = start - now
                transfer += end - start
                if cache is not None:
                    cache.insert_batch(still_keys, pc)
        self._o_lat[idx] = latency
        self._o_tra[idx] = transfer
        self._o_loc[idx] = local_b
        self._o_pref[idx] = pref_b
        self._o_peer[idx] = peer_b
        self._o_org[idx] = origin_b
        self._o_pt[idx] = peer_t

    def _serve_event_scalar(self, idx: int, now: float, dtn: int,
                            absorbed: bool, track_pref: bool, kk: int,
                            pc: int, lo: int, hi: int, cache) -> None:
        """Scalar mirror of the reference ``_serve`` for tiny chunk counts;
        float accumulation order matches the reference exactly."""
        present = cache.present
        prow = self._pref2d[dtn] if track_pref else None
        local_b = pref_b = peer_b = origin_b = 0
        transfer = 0.0
        latency = 0.0
        peer_t = 0.0
        nh = 0
        missing = None
        ulink = self._ulink
        for k in range(lo, hi):
            if present[k]:
                nh += 1
                if track_pref and prow[k] == 1:
                    prow[k] = 2
                    self._pref_used += 1
                    pref_b += pc
                else:
                    local_b += pc
                transfer += pc / ulink
                cache.touch_one(k)
            elif missing is None:
                missing = [k]
            else:
                missing.append(k)
        cache.record_lookup(nh, kk - nh, pc)
        still = missing
        if missing and self.cfg.enable_peer_cache:
            still = None
            bw_l = self._bw_l
            row0 = bw_l[0][dtn]
            p2 = self._present2d
            for k in missing:
                best, best_bw = None, 0.0
                for d in range(1, self.n_dtn):
                    if d != dtn and p2[d, k] and bw_l[d][dtn] > best_bw:
                        best, best_bw = d, bw_l[d][dtn]
                if best is not None and best_bw > row0:
                    peer_b += pc
                    dt_ = pc / best_bw
                    transfer += dt_
                    peer_t += dt_
                    cache.insert_one(k, pc)
                elif still is None:
                    still = [k]
                else:
                    still.append(k)
        if still:
            ob = pc * len(still)
            if absorbed:
                transfer += ob / ulink
                local_b += ob
            else:
                origin_b = ob
                start, end = self.origin.submit(now, self._origin_dur(ob, dtn))
                latency = start - now
                transfer += end - start
                for k in still:
                    cache.insert_one(k, pc)
        self._o_lat[idx] = latency
        self._o_tra[idx] = transfer
        self._o_loc[idx] = local_b
        self._o_pref[idx] = pref_b
        self._o_peer[idx] = peer_b
        self._o_org[idx] = origin_b
        self._o_pt[idx] = peer_t

    # -- prefetch / push / placement -----------------------------------------

    def _apply_prefetch(self, op: PrefetchOp, now: float) -> None:
        if not self.use_cache:
            return
        dtn = self._user_dtn.get(op.user_id)
        if dtn is None:
            return
        cs = self.cfg.chunk_seconds
        e = min(op.tr_end, now)
        if e <= op.tr_start:
            return
        c_first = int(math.floor(op.tr_start / cs))
        c_last = int(math.ceil(e / cs))
        keys = self._encode_range(op.obj, c_first, c_last)
        # only finalized chunks ship via pre-fetch (live tail is streaming's)
        cvec = np.arange(c_first, c_last, dtype=np.int64)
        keys = keys[(cvec + 1) * cs <= now]
        if not len(keys):
            return
        cache = self.caches[dtn]
        new_keys = keys[~self._present2d[dtn, keys]]
        if not len(new_keys):
            return
        nbytes = self._chunk_bytes * len(new_keys)
        self.origin.submit(now, self._origin_dur(nbytes, dtn),
                           with_overhead=False)
        cache.insert_batch(new_keys, self._chunk_bytes)
        self._mark_prefetched(dtn, new_keys)

    def _mark_prefetched(self, dtn: int, keys: np.ndarray) -> None:
        row = self._pref2d[dtn]
        fresh = keys[row[keys] == 0]
        if len(fresh):
            row[fresh] = 1
            self._pref_issued += len(fresh)

    def _apply_push(self, push) -> None:
        if not self.use_cache:
            return
        cs = self.cfg.chunk_seconds
        c_first = int(math.floor(push.tr_start / cs))
        if push.tr_end > push.tr_start:
            c_last = int(math.ceil(push.tr_end / cs))
        else:
            # sub-chunk push: still mark the covering chunk
            c_last = int(math.ceil((push.tr_start + cs) / cs))
        n = c_last - c_first
        nbytes = int((push.tr_end - push.tr_start)
                     * self.cfg.stream_rate_bytes_per_s)
        self.origin.submit(
            push.ts,
            self._origin_dur(nbytes, push.dtns[0]) if push.dtns else 0.0,
            with_overhead=False)
        size_each = max(1, nbytes // n)
        if n <= 4 and c_first + self._off >= 0 and \
                c_last + self._off <= self._span:
            # pushes cover 1-2 publication intervals: scalar path avoids
            # ~40us of array dispatch per push (hpm replays millions)
            base = push.obj * self._span + self._off
            key_list = list(range(base + c_first, base + c_last))
            for d in push.dtns:
                cache = self.caches.get(d)
                if cache is None:
                    continue
                cache.upsert_seq(key_list, size_each)
                row = self._pref2d[d]
                for k in key_list:
                    if row[k] == 0:
                        row[k] = 1
                        self._pref_issued += 1
            return
        keys = self._encode_range(push.obj, c_first, c_last)
        for d in push.dtns:
            if d in self.caches:
                self.caches[d].upsert_batch(keys, size_each)
                self._mark_prefetched(d, keys)

    def _find_peer_scalar(self, key: int, dtn: int) -> int | None:
        best, best_bw = None, 0.0
        col = self._present2d[:, key]
        for d in range(1, self.n_dtn):
            if d == dtn or not col[d]:
                continue
            b = self.bw[d, dtn]
            if b > best_bw:
                best, best_bw = d, b
        return best

    def _run_placement(self, now: float) -> None:
        if not self._recent_requests or not self.use_cache:
            return
        util = {d: 1.0 - c.used / max(1, c.capacity)
                for d, c in self.caches.items()}
        groups = self.placement.recluster(
            list(self._recent_requests), self._user_dtn,
            self.bw / GBPS, util,
        )
        cs = self.cfg.chunk_seconds
        for g in groups:
            hub = g.hub_dtn
            if hub not in self.caches:
                continue
            cache = self.caches[hub]
            row = self._present2d[hub]
            for obj in g.hot_objs:
                s = max(0.0, now - 24 * 3600.0)
                if now <= s:
                    continue
                c_first = int(math.floor(s / cs))
                c_last = int(math.ceil(now / cs))
                c_first = max(c_first, c_last - 4)       # recent[-4:]
                keys = self._encode_range(int(obj), c_first, c_last)
                row = self._present2d[hub]                # may move on grow
                new = keys[~row[keys]]
                for key in new.tolist():
                    src = self._find_peer_scalar(key, hub)
                    if src is None:
                        self.origin.submit(
                            now, self._origin_dur(self._chunk_bytes, hub),
                            with_overhead=False)
                    cache.insert_batch(np.array([key], np.int64),
                                       self._chunk_bytes)
                    self._mark_prefetched(hub, np.array([key], np.int64))

