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
"""
from __future__ import annotations

import collections
import collections.abc
import heapq
import itertools
import math
from typing import Sequence

import numpy as np

from repro_torch.core.cache import (CacheStats, IntervalLRUState, chunk_bytes,
                                    chunk_bounds_bulk, make_int_cache_state)
from repro_torch.core.interval_store import FlatIntervalState
from repro_torch.core.delivery import (PeerFetchRange,
                                       coalesce_peer_ranges,
                                       select_peer_sources,
                                       select_peer_sources_ranges)
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


# ---------------------------------------------------------------------------
# Interval-algebra replay (third engine mode)
# ---------------------------------------------------------------------------
#
# The vector engine above still spends O(total chunk positions) on the
# serving path.  The interval engine replays static strategies (no dynamic
# events) on interval cache states — presence, sizes and LRU recency as
# sorted disjoint [start, end) chunk-id intervals
# (:class:`repro_torch.core.cache.IntervalLRUState`,
# :class:`repro_torch.core.interval_store.FlatIntervalState`) — in two
# phases:
#
#   1. one trace-order pass over every DTN's cache, with peer fetches
#      resolved inline against the other caches' current coverage (the
#      paper's §IV-D resolution order, and the reference's peer-before-
#      origin insert order, applied exactly): the fused block replay below
#      in the coarse regime, the per-request sweep (:func:`_sweep_serve`)
#      in the fine-chunking regime;
#   2. origin-queue replay.  Requests with chunks left over after peer
#      resolution walk the (inherently sequential, but tiny) origin task
#      queue in trace order — identical float arithmetic to the reference.
#
# ``repro``'s interval engine also has an optimistic sharded mode
# (``SimConfig.interval_shards``: forked per-DTN replays, presence
# timelines and an exactness audit).  The port leaves it out: no workload
# of the repo selects it, and on the one trace measured on the card's host
# (OOI 1.0) it ran slower than the vector engine and its audit always fell
# back to the sweep (``ROADMAP.md``).  Counter equivalence with the other
# engines is unconditional (tests/test_torch_engine_interval.py).


# --------------------------------------------------------------------------
# fused block-over-intervals replay
#
# The coarse-regime hot path: classify a whole *block* of requests against
# block-start IntervalLRUState snapshots instead of per-chunk arrays.  The
# exactness argument is the vector engine's, lifted to intervals:
#
# - the block's key union is handed to the eviction planner as a *blocked*
#   set, and the block is truncated so its committed inserts never need to
#   evict a blocked key — therefore no in-block key (hit, dup or peer
#   lookup target, on ANY DTN) can disappear mid-block, and the block-start
#   snapshots stay valid for every in-block decision;
# - chunk ranges are cut into *elementary cells* at every request endpoint
#   and every snapshot segment boundary, so each cell is uniform w.r.t.
#   every DTN's presence and every request's coverage; per (DTN, cell) a
#   first-coverage / last-coverage attribution replaces the vector path's
#   per-chunk radix sort: a cell is a hit for request r iff it was present
#   at block start or first touched by an earlier in-block request, else it
#   is r's insert (and r resolves its peer source against the other DTNs'
#   snapshot-or-earlier-touch coverage — the reference's §IV-D rule);
# - block evictions collapse to the existing `_evict_until(cum_bytes, r)`
#   per triggering request: the reference's interleaved per-chunk
#   evict-then-insert loop frees, by the end of request r, exactly the
#   minimal LRU-order chunk prefix covering the cumulative insert bytes
#   through r — which is what `_evict_until` computes when handed that
#   cumulative as its `size` argument (inserts are committed after);
# - commits land as run merges: one size-map record per inserting request's
#   maximal miss run, one recency record per merged (last toucher, phase)
#   run ordered by (request, hit/peer/origin phase, key) — the reference's
#   final per-chunk stamp order, so FIFO order and hence future evictions
#   are exact.  Intermediate stamps of multiply-touched chunks are never
#   observable (nothing in-block is evicted), so only final stamps matter.
# --------------------------------------------------------------------------


def _merge_key_runs(lo: np.ndarray,
                    hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Union of ``[lo, hi)`` key ranges as sorted disjoint runs
    ``(starts, ends)``; abutting ranges merge."""
    n = len(lo)
    ev = np.concatenate((lo, hi))
    typ = np.concatenate((np.ones(n, np.int64), np.full(n, -1, np.int64)))
    # stable: at equal keys the starts (first half) sort ahead of the ends,
    # so touching ranges stay one run
    order = ev.argsort(kind="stable")
    ev = ev[order]
    depth = typ[order].cumsum()
    prev = np.concatenate(([0], depth[:-1]))
    return ev[(prev == 0) & (depth > 0)], ev[(depth == 0) & (prev > 0)]


_FUSED_MAX_INCIDENCE = 1 << 21


def _fused_block_replay(states: dict, bw, enable_peer: bool,
                        pos_a: np.ndarray, dtn_a: np.ndarray,
                        obj_a: np.ndarray, lo_a: np.ndarray,
                        hi_a: np.ndarray, pc_a: np.ndarray,
                        ctr: dict | None = None,
                        blk_state: dict | None = None):
    """Fused replay of one request sequence (trace order) over per-DTN
    interval caches (all :class:`FlatIntervalState` or all
    :class:`IntervalLRUState`): all DTNs interleaved, peer ranges resolved
    inline against the block snapshots (exact, no audit).  Returns
    per-request ``(nh, peer_chunks, peer_dt, still_chunks, peer_ranges)``.

    Blocks under eviction pressure are replayed in PHASES: the fitting
    prefix is committed, victims are evicted at the phase boundary, and
    the same decomposition continues — so one block can span many
    multiples of cache capacity (see the phase-loop section below for the
    legal-victim invariant).  ``blk_state``, when given, carries the
    adaptive block sizing across calls (the windowed replay passes a
    persistent dict so window edges do not reset it).
    """
    n = len(pos_a)
    if ctr is None:
        ctr = {"plan": 0, "trunc": 0, "degen": 0, "phases": 0, "invict": 0}
    n_dtn = max(states) + 1
    cap = next(iter(states.values())).capacity
    active = sorted(states)
    # homogeneous state bank: flat states take the batched array APIs
    # (plan_evict_clean on key-run arrays, commit_block_arrays)
    flat = getattr(next(iter(states.values())), "flat", False)
    nh_loc = np.zeros(n, np.int64)
    acc_loc = np.zeros(n, np.int64)
    pdt_loc = np.zeros(n, np.float64)
    still_loc = np.zeros(n, np.int64)
    peer_ranges: list = []
    # peer candidates per DTN, best-first, for the scalar fallback
    # (same pruning + greedy order as the sequential sweep)
    cands: dict[int, list] = {}
    for d in active:
        ob = float(bw[0, d])
        cl = [(float(bw[d2, d]), d2) for d2 in active
              if d2 != d and float(bw[d2, d]) > ob]
        cl.sort(key=lambda t: (-t[0], t[1]))
        cands[d] = cl

    def serve_scalar(r: int) -> None:
        ctr["degen"] += 1
        d = int(dtn_a[r]); o = int(obj_a[r])
        lo = int(lo_a[r]); hi = int(hi_a[r])
        pc = int(pc_a[r]); ridx = int(pos_a[r])
        st = states[d]
        nh, miss = st.lookup_touch(o, lo, hi, pc)
        nh_loc[r] = nh
        if not miss:
            return
        n_acc = 0
        peer_dt = 0.0
        if enable_peer:
            unassigned = miss
            acc_runs: list = []
            for bwv, d2 in cands[d]:
                if not unassigned:
                    break
                cov_of = states[d2].coverage_runs
                rem: list = []
                for a, b_ in unassigned:
                    p2 = a
                    for s, e in cov_of(o, a, b_):
                        if s > p2:
                            rem.append((p2, s))
                        acc_runs.append((s, e))
                        n_acc += e - s
                        peer_dt += (e - s) * (pc / bwv)
                        peer_ranges.append(PeerFetchRange(ridx, d, d2, s, e))
                        p2 = e
                    if p2 < b_:
                        rem.append((p2, b_))
                unassigned = rem
            if acc_runs:
                acc_runs.sort()
                st.insert_runs(o, acc_runs, pc, ridx)
            still = unassigned
        else:
            still = miss
        if still:
            still_loc[r] = sum(b_ - a for a, b_ in still)
            st.insert_runs(o, still, pc, ridx)
        acc_loc[r] = n_acc
        pdt_loc[r] = peer_dt

    i = 0
    blk = 512 if blk_state is None else blk_state.get("blk", 512)
    degen = 0 if blk_state is None else blk_state.get("degen", 0)
    BIG = 1 << 62
    while i < n:
        if degen >= 4:
            # eviction-bound stretch: blocks keep collapsing, so serve a
            # run of requests scalarly before re-probing the block path
            stop = min(n, i + 256)
            for r in range(i, stop):
                serve_scalar(r)
            i = stop
            degen = 0
            blk = 512
            continue
        j = min(n, i + blk)
        cap_nb = 0
        while True:
            # ---- elementary-cell decomposition of [i, j) ------------------
            # computed ONCE per block and reused by every phase (cells,
            # snapshots and first-touch attribution are all prefix-stable,
            # and the suffix-blocking invariant below keeps them exact
            # across mid-block evictions)
            B = j - i
            lo = lo_a[i:j]; hi = hi_a[i:j]
            dt_b = dtn_a[i:j]; pc_b = pc_a[i:j]
            us, ue = _merge_key_runs(lo, hi)
            o_blk = np.unique(obj_a[i:j]).tolist()
            covs = {d: states[d].coverage_arrays(o_blk) for d in active}
            pts = [lo, hi]
            for d in active:
                cs, ce = covs[d]
                if len(cs):
                    # keep only segments overlapping the block's key union
                    u_idx = ue.searchsorted(cs, side="right")
                    ok = u_idx < len(us)
                    ov = np.zeros(len(cs), bool)
                    ov[ok] = us[u_idx[ok]] < ce[ok]
                    if ov.any():
                        pts.append(cs[ov])
                        pts.append(ce[ov])
            C = np.unique(np.concatenate(pts))
            rs = C.searchsorted(lo)
            re_ = C.searchsorted(hi)
            cnt = re_ - rs
            cum = cnt.cumsum()
            if int(cum[-1]) > _FUSED_MAX_INCIDENCE and B > 1:
                nb = max(1, int(cum.searchsorted(
                    _FUSED_MAX_INCIDENCE, side="right")))
                if nb < B:
                    j = i + nb
                    cap_nb = nb
                    continue
            break
        I = int(cum[-1])
        M = len(C) - 1
        cell_len = C[1:] - C[:-1]
        inc = np.arange(B).repeat(cnt)
        cell = np.arange(I) - (cum - cnt - rs).repeat(cnt)
        # ---- snapshot presence + first-touch attribution ------------------
        clo = C[:-1]
        snap = np.zeros((n_dtn, M), bool)
        for d in active:
            cs, ce = covs[d]
            if len(cs):
                ix = cs.searchsorted(clo, side="right") - 1
                ok = ix >= 0
                snap[d, ok] = ce[ix[ok]] > clo[ok]
        first2 = np.full((n_dtn, M), BIG, np.int64)
        d_inc = dt_b[inc]
        # ``inc`` ascends, and duplicate fancy-index writes land last-wins,
        # so a reversed scatter leaves each (DTN, cell)'s FIRST toucher —
        # no per-DTN sort.  The reversed index arrays must be materialized:
        # setitem walks index arrays in memory order, and a negative-stride
        # view would silently restore the forward write order.  First
        # touchers are prefix-stable: a cell touched by request r has
        # first <= r, so every truncated prefix below reuses this scatter.
        first2[np.ascontiguousarray(d_inc[::-1]),
               np.ascontiguousarray(cell[::-1])] = (
                   np.ascontiguousarray(inc[::-1]))
        snap_inc = snap[d_inc, cell]
        first_inc = first2[d_inc, cell]
        hit = snap_inc | (first_inc < inc)
        ins_idx = (~hit).nonzero()[0]     # first-touch absent cells
        ins_inc = inc[ins_idx]            # non-decreasing (inc ascends)
        ins_cell = cell[ins_idx]
        ins_d = d_inc[ins_idx]
        ins_len = cell_len[ins_cell]
        ins_bytes = ins_len * pc_b[ins_inc]
        # ---- phased eviction planning -------------------------------------
        # Mid-block eviction phases replace the old truncation refinement:
        # when the block's inserts exceed free room, the fitting prefix is
        # committed as a PHASE, victims are evicted at the phase boundary,
        # and the block continues on the same decomposition.  Legal-victim
        # invariant: planning at boundary p0 blocks the GLOBAL key union of
        # the remaining suffix [p0, B), so a key referenced at-or-after p0
        # by any request is never evicted at any boundary <= p0.  Hence
        # (a) the block-start snapshot + first-touch hit classification
        # stays exact for the whole block, (b) the block-level peer holders
        # stay exact (a queried cell belongs to the querying request's
        # keys, hence is blocked at every earlier boundary for every DTN),
        # and (c) each boundary eviction's FIFO prefix equals the
        # reference's per-insert eviction sequence: plan_evict_clean stops
        # at the first blocked record, and any record the reference had
        # re-queued meanwhile (an in-phase re-touch) is blocked, so the
        # consumed prefix is identical order-for-order.
        cum_ins: dict[int, np.ndarray] = {}
        for d in active:
            m_ = ins_d == d
            if m_.any():
                cum_ins[d] = np.bincount(
                    ins_inc[m_], weights=ins_bytes[m_],
                    minlength=B).astype(np.int64).cumsum()
        # the reference silently skips oversized inserts; the block ends at
        # the first one and it is served scalarly so later touches of its
        # keys stay misses
        over_big = (pc_b > cap).nonzero()[0]
        b_big = int(over_big[0]) if len(over_big) else B

        def plan_boundary(p0: int) -> int:
            """Furthest request the block can advance to from boundary
            ``p0``: the longest prefix of the remaining suffix whose
            per-DTN insert bytes fit free room plus clean (suffix-blocked)
            evictable bytes, capped at the first oversized insert."""
            b_new = b_big
            if b_new == p0 or not cum_ins:
                return b_new
            if p0 == 0:
                us_c, ue_c = us, ue
            else:
                us_c, ue_c = _merge_key_runs(lo[p0:], hi[p0:])
            # the flat state takes the blocked key runs as arrays; the
            # list state wants Python lists (bisect)
            bs_l = ((us_c, ue_c) if flat
                    else (us_c.tolist(), ue_c.tolist()))
            for d in active:
                cum_d = cum_ins.get(d)
                if cum_d is None:
                    continue
                base = int(cum_d[p0 - 1]) if p0 else 0
                total = int(cum_d[-1]) - base
                if total <= 0:
                    continue
                st = states[d]
                room = st.capacity - st.used
                if total <= room:
                    continue
                # contract: the result is only compared against the byte
                # shortfall (total - room) and clamped there —
                # plan_evict_clean may cap its answer at max_need, and any
                # overshoot past it must never change b_new
                ctr["plan"] += 1
                clean = st.plan_evict_clean(total - room, *bs_l)
                if total > room + clean:
                    b_new = min(b_new, p0 + int(cum_d[p0:].searchsorted(
                        base + room + clean, side="right")))
            return b_new

        def evict_phase(p0: int, b1: int) -> None:
            """Evict at boundary ``p0`` for the inserts of phase
            ``[p0, b1)``, replaying the reference's cumulative per-request
            arithmetic.  Chunks evicted at mid-block boundaries (p0 > 0)
            are in-block victims: keys whose last remaining reference
            preceded the boundary."""
            inblock = p0 > 0
            for d in active:
                cum_d = cum_ins.get(d)
                if cum_d is None:
                    continue
                base = int(cum_d[p0 - 1]) if p0 else 0
                st = states[d]
                ev0 = st.evictions
                # one call with the phase's final cumulative need: LRU
                # prefix consumption is monotone, so evicting for the
                # per-request cumulative values in sequence lands on the
                # same final prefix
                cv = int(cum_d[b1 - 1]) - base
                if cv > 0 and st.used + cv > st.capacity:
                    st._evict_until(cv, int(pos_a[i + b1 - 1]))
                if inblock:
                    ctr["invict"] += st.evictions - ev0

        b1 = plan_boundary(0)
        if b1 == 0:
            ctr["trunc"] += 1
            serve_scalar(i)
            i += 1
            degen += 1
            blk = max(256, blk >> 1)
            continue
        # ---- peer resolution for the block's insert cells -----------------
        # block-level, BEFORE any commit or eviction: resolved per insert
        # column from the block-start snapshot + first-touch attribution,
        # which the suffix-blocking invariant keeps exact for every phase;
        # the per-request accounting below filters to the committed extent
        n_ins = len(ins_idx)
        acc2 = None
        acc = np.zeros(n_ins, bool)
        if enable_peer and n_ins:
            holders = np.zeros((n_dtn, n_ins), bool)
            for d2 in active:
                # a DTN holds a cell at serve time iff it was present at
                # block start or an earlier in-block request of that DTN
                # touched it (hit or insert — suffix blocking guarantees
                # no boundary eviction ever removes a still-queried cell)
                holders[d2] = (snap[d2, ins_cell]
                               | (first2[d2, ins_cell] < ins_inc))
            # own-DTN entries are False by construction (the first toucher
            # defines the insert); the origin row was never set
            src, best_bw, acc = select_peer_sources_ranges(
                bw[:, ins_d], holders)
            acc2 = np.zeros((n_dtn, M), bool)
            acc2[ins_d[acc], ins_cell[acc]] = True

        def commit_one(st, d, uc, fi, la, ins_flag):
            """Commit one DTN's merged runs for one phase: ``uc`` the
            touched cells (ascending), ``fi``/``la`` the phase's first and
            last toucher per cell, ``ins_flag`` the cells whose insert this
            phase performs."""
            size_recs: list = []
            z_parts = None
            if ins_flag.any():
                iuc = uc[ins_flag]
                ifi = fi[ins_flag]
                o2 = np.lexsort((iuc, ifi))   # trace order, ascending keys
                iuc = iuc[o2]; ifi = ifi[o2]
                brk = np.empty(len(iuc), bool)
                brk[0] = True
                # size records only feed the size map and byte accounting,
                # both invariant under merging contiguous equal-size runs —
                # and per-object chunk sizes rarely change, so this
                # collapses a phase's inserts to ~one splice per object
                ipc = pc_b[ifi]
                iob = obj_a[i + ifi]
                brk[1:] = ((ipc[1:] != ipc[:-1]) | (iob[1:] != iob[:-1])
                           | (iuc[1:] != iuc[:-1] + 1))
                gs = brk.nonzero()[0]
                ge = np.append(gs[1:], len(iuc)) - 1
                if flat:
                    # hand the column arrays straight to the flat state
                    z_parts = (obj_a[i + ifi[gs]], C[iuc[gs]],
                               C[iuc[ge] + 1], pos_a[i + ifi[gs]],
                               pc_b[ifi[gs]])
                else:
                    size_recs = list(zip(
                        obj_a[i + ifi[gs]].tolist(), C[iuc[gs]].tolist(),
                        C[iuc[ge] + 1].tolist(), pos_a[i + ifi[gs]].tolist(),
                        pc_b[ifi[gs]].tolist()))
            # final recency order: (last toucher, hit/peer/origin phase,
            # ascending key) — single-touch inserts carry their phase, every
            # re-touched cell ends as a plain hit touch of its last toucher
            single = ins_flag & (fi == la)
            if acc2 is not None:
                ph = np.where(single, np.where(acc2[d, uc], 1, 2), 0)
            else:
                ph = np.where(single, 2, 0)
            src_rec = np.where(single, pos_a[i + la], -1)
            o3 = np.lexsort((uc, ph, la))
            uc3 = uc[o3]; ph3 = ph[o3]
            la3 = la[o3]; sr3 = src_rec[o3]
            brk = np.empty(len(uc3), bool)
            brk[0] = True
            # the FIFO consumes records front-to-back and chunks ascending
            # within a record, so records adjacent in commit order with
            # contiguous ascending keys evict identically whether split or
            # merged.  Merge maximally: only a key gap or an object change
            # forces a new record.  Shorter FIFOs make every later eviction
            # scan cheaper.
            ob3 = obj_a[i + la3]
            brk[1:] = (uc3[1:] != uc3[:-1] + 1) | (ob3[1:] != ob3[:-1])
            # group fusion: consecutive records of one object with strictly
            # ascending (gap-allowed) key runs share ONE rid and ONE FIFO
            # record — ascending disjoint runs under a single rid consume
            # front-to-back exactly like adjacent split records, and the
            # gaps' keys belong to other rids (evictions filter by rid
            # ownership).  A group boundary is a subset condition of a
            # record boundary, so ``r_grp`` is piecewise-constant over the
            # ``gs`` records.
            grp_brk = np.empty(len(uc3), bool)
            grp_brk[0] = True
            grp_brk[1:] = ((uc3[1:] <= uc3[:-1]) | (ob3[1:] != ob3[:-1]))
            gs = brk.nonzero()[0]
            ge = np.append(gs[1:], len(uc3)) - 1
            r_grp = np.cumsum(grp_brk[gs]) - 1
            if flat:
                if z_parts is None:
                    e_ = np.empty(0, np.int64)
                    z_parts = (e_, e_, e_, e_, e_)
                st.commit_block_arrays(*z_parts, obj_a[i + la3[gs]],
                                       C[uc3[gs]], C[uc3[ge] + 1], sr3[gs],
                                       r_grp)
            else:
                rec_recs = list(zip(
                    obj_a[i + la3[gs]].tolist(), C[uc3[gs]].tolist(),
                    C[uc3[ge] + 1].tolist(), sr3[gs].tolist()))
                st.commit_block(size_recs, rec_recs, r_grp)

        def commit_phase(p0: int, b1: int) -> None:
            """Commit phase ``[p0, b1)``: group its incidence slice by
            (DTN, cell) — the stable lexsort keeps touchers ascending
            inside each group — and commit every DTN's merged runs with
            per-phase first/last attribution."""
            e0 = int(cum[p0 - 1]) if p0 else 0
            e1 = int(cum[b1 - 1])
            if e1 == e0:
                return
            cell_p = cell[e0:e1]
            d_p = d_inc[e0:e1]
            o_s = np.lexsort((cell_p, d_p))
            ds = d_p[o_s]
            cs = cell_p[o_s]
            iq = inc[e0:e1][o_s]
            nrun = np.empty(len(ds), bool)
            nrun[0] = True
            nrun[1:] = (ds[1:] != ds[:-1]) | (cs[1:] != cs[:-1])
            g0 = nrun.nonzero()[0]
            g1 = np.append(g0[1:], len(ds)) - 1
            ud = ds[g0]
            for d in active:
                s0, s1 = np.searchsorted(ud, (d, d + 1))
                if s1 == s0:
                    continue
                gg0 = g0[s0:s1]
                gg1 = g1[s0:s1]
                uc = cs[gg0]
                fi = iq[gg0]
                la = iq[gg1]
                # a cell is this phase's insert iff its block-level first
                # touch lands in this phase and missed the block snapshot;
                # cells inserted by an earlier phase and re-touched here
                # commit as plain hit touches
                ins_flag = (~snap[d, uc]) & (first2[d, uc] == fi)
                commit_one(states[d], d, uc, fi, la, ins_flag)

        # ---- phase loop ---------------------------------------------------
        # Per-phase commits are mandatory: the next boundary's eviction
        # walks the FIFO, so every cell touched in a committed phase must
        # carry its phase-last recency stamp before that walk — an
        # uncommitted touch would leave a pre-block record at the FIFO
        # front that the reference had already re-queued to the back.
        was_trunc = False
        n_phase = 0
        if b1 == B:
            # single full-block phase (no pressure, or the clean evictable
            # prefix covers the whole block): scatter-based last-touch
            # attribution, one commit per DTN
            evict_phase(0, B)
            last2 = np.full((n_dtn, M), -1, np.int64)
            # forward scatter, last-wins: each (DTN, cell)'s last toucher
            last2[d_inc, cell] = inc
            for d in active:
                row = last2[d]
                uc = (row >= 0).nonzero()[0]  # ascending touched cells
                if len(uc):
                    commit_one(states[d], d, uc, first2[d, uc], row[uc],
                               ~snap[d, uc])
            B_final = B
            n_phase = 1
        else:
            p0 = 0
            b_next = b1
            while True:
                evict_phase(p0, b_next)
                commit_phase(p0, b_next)
                n_phase += 1
                if p0:
                    ctr["phases"] += 1
                p0 = b_next
                if p0 == B or n_phase >= _FUSED_PHASE_MAX:
                    # block done — or the per-boundary suffix work has been
                    # paid enough times: end the block cleanly here and let
                    # the next (adaptively resized) block pick up
                    break
                b_next = plan_boundary(p0)
                if b_next == p0:
                    # no progress possible: the boundary request is the
                    # blocker (oversized insert or an empty clean prefix)
                    was_trunc = True
                    break
            B_final = p0
        # ---- per-request / per-DTN accounting (committed extent) ----------
        j = i + B_final
        if B_final < B:
            e_i = int(cum[B_final - 1])
            B = B_final
            inc = inc[:e_i]; cell = cell[:e_i]
            hit = hit[:e_i]
            ni = int(ins_inc.searchsorted(B_final))
            ins_inc = ins_inc[:ni]; ins_cell = ins_cell[:ni]
            ins_d = ins_d[:ni]; ins_len = ins_len[:ni]
            acc = acc[:ni]
            if acc2 is not None:
                src = src[:ni]; best_bw = best_bw[:ni]
            dt_b = dt_b[:B_final]; pc_b = pc_b[:B_final]
            n_ins = ni
        hit_i = hit.nonzero()[0]
        hlen = cell_len[cell[hit_i]]
        nh_b = np.bincount(inc[hit_i], weights=hlen,
                           minlength=B).astype(np.int64)
        nm_b = np.bincount(ins_inc, weights=ins_len,
                           minlength=B).astype(np.int64)
        for d in active:
            md = dt_b == d
            if not md.any():
                continue
            st = states[d]
            st.hits += int(nh_b[md].sum())
            st.hit_bytes += int((nh_b[md] * pc_b[md]).sum())
            st.misses += int(nm_b[md].sum())
            st.miss_bytes += int((nm_b[md] * pc_b[md]).sum())
        nh_loc[i:j] = nh_b
        if n_ins:
            na = np.bincount(ins_inc[acc], weights=ins_len[acc],
                             minlength=B).astype(np.int64)
            acc_loc[i:j] = na
            still_loc[i:j] = nm_b - na
            if acc.any():
                pdt_loc[i:j] = np.bincount(
                    ins_inc[acc],
                    weights=ins_len[acc]
                    * (pc_b[ins_inc[acc]] / best_bw[acc]),
                    minlength=B)
                peer_ranges.extend(coalesce_peer_ranges(
                    pos_a[i + ins_inc[acc]], ins_d[acc], src[acc],
                    C[ins_cell[acc]], C[ins_cell[acc] + 1]))
        i = j
        if was_trunc:
            ctr["trunc"] += 1
            # the blocker request is served scalarly right away (exact for
            # oversize inserts and eviction pressure alike)
            if i < n:
                serve_scalar(i)
                i += 1
            degen += 1 if B_final < 8 else 0
            blk = max(256, blk >> 1)
        else:
            degen = 0
            if n_phase > 12:
                # heavy phasing: each boundary pays an O(suffix) key merge
                # and plan, so size the next block to land near ~8 phases
                blk = max(256, min(65536, (B_final * 8) // n_phase))
            elif cap_nb:
                # the incidence cap cut this block down from ``blk``; size
                # the next block near the achieved cut so its first
                # decomposition pass is not paid at many times the kept size
                blk = max(256, min(65536, cap_nb + (cap_nb >> 2)))
            else:
                blk = min(blk << 1, 65536)
    if blk_state is not None:
        blk_state["blk"] = blk
        blk_state["degen"] = degen
    return nh_loc, acc_loc, pdt_loc, still_loc, peer_ranges


class IntervalVDCSimulator(VectorVDCSimulator):
    """Third replay engine: interval-algebra presence tracking (see the
    module-section comment above).

    Drop-in for the other engines.  The static LRU serving path goes
    through a small *replay planner*:

    - in the **coarse regime** (mean chunk positions per live request below
      ``SWEEP_MIN_CHUNKS_PER_REQ``) it runs the **fused block-over-
      intervals replay** (:meth:`_run_fused` / :func:`_fused_block_replay`):
      the vector engine's block discipline — block-start snapshot,
      first/last-coverage classification, truncation so nothing in-block is
      ever evicted — executed directly on :class:`FlatIntervalState`, with
      run-level peer resolution, run-merge commits and run-split evictions
      instead of per-chunk radix sorts and scatters;
    - in the **fine-chunking regime** (sub-five-minute chunks on the
      paper's traces) it runs the sequential global sweep
      (:meth:`_run_sweep`) on :class:`IntervalLRUState`, whose per-request
      cost is governed by *segment* counts, not chunk counts.

    A :class:`StreamingRequestSource` with a ``tr_bounds`` hint takes the
    same two routes window by window (:meth:`_run_stream_interval`).

    Strategies with dynamic events (prefetch / streaming / placement), LFU
    caches and ``use_cache=False`` runs always delegate to the inherited
    vector paths.  All routes produce identical integer counters
    (``tests/test_torch_engine_interval.py``).
    """

    #: auto-planner threshold: mean chunk positions per live request above
    #: which the interval sweep beats block replay (measured crossover on
    #: the 2-core reference container lies between 55 and 280)
    SWEEP_MIN_CHUNKS_PER_REQ = 96.0

    #: filled by the last static interval run: accepted peer transfers as
    #: coalesced (req_pos, dtn, src, key_lo, key_hi) ranges
    last_peer_fetches: list

    def run(self, requests: Sequence[Request], name: str = "") -> SimResult:
        self.last_peer_fetches = []
        stream_engine = getattr(self.pf, "streaming", None)
        static = (self.placement is None and stream_engine is None
                  and getattr(self.pf, "static", False))
        eligible = (static and self.use_cache
                    and self.cfg.cache_policy.lower() == "lru")
        if isinstance(requests, StreamingRequestSource):
            # A source without a tr-bounds hint cannot pre-size the key
            # space and falls back to the inherited (equally exact) vector
            # streaming path.  ``last_peer_fetches`` stays empty in
            # streaming mode — accumulating it would grow with the trace.
            if eligible and requests.tr_bounds is not None:
                return self._run_stream_interval(requests, name)
            return super().run(requests, name)
        if not eligible:
            return super().run(requests, name)
        return self._run_static_interval(requests, name)

    # -- dispatcher ----------------------------------------------------------

    def _run_static_interval(self, requests: Sequence[Request],
                             name: str) -> SimResult:
        cfg = self.cfg
        arr = requests_to_arrays(requests)
        n_req = len(arr)
        scale = 1.0 / cfg.traffic_scale
        now_arr = arr.ts * scale
        first, n_chunks = chunk_bounds_bulk(
            arr.tr_start, np.minimum(arr.tr_end, now_arr), cfg.chunk_seconds)
        zero = (n_chunks == 0) | (arr.size_bytes == 0)
        k_eff = np.where(zero, 0, n_chunks)
        per_chunk = np.maximum(1, arr.size_bytes // np.maximum(1, n_chunks))
        dtn_arr = arr.continent + 1
        live = k_eff > 0
        if live.any():
            lo_min = int(first[live].min())
            hi_max = int((first + k_eff)[live].max())
        else:
            lo_min, hi_max = 0, 1
        off = max(0, -lo_min) + 8
        span = hi_max + off + 8
        n_live = int(live.sum())
        mean_k = float(k_eff[live].sum()) / n_live if n_live else 0.0
        P = dict(arr=arr, n_req=n_req, now=now_arr, zero=zero, k_eff=k_eff,
                 pc=per_chunk, dtn=dtn_arr, obj=arr.obj,
                 base=arr.obj * span + first + off, mean_k=mean_k)
        if mean_k < self.SWEEP_MIN_CHUNKS_PER_REQ:
            # coarse regime: the fused block-over-intervals replay (inline
            # peers against block snapshots — always exact)
            out = self._run_fused(P)
        else:
            # fine regime: the sequential sweep
            out = self._run_sweep(P)
        return self._finish(P, out, name)

    # -- streaming entry (windowed static-LRU interval replay) ---------------

    def _run_stream_interval(self, source: StreamingRequestSource,
                             name: str) -> SimResult:
        """Static-LRU interval replay over a windowed source.

        The dense key space is fixed up front from the source's
        ``tr_bounds`` hint instead of the trace's observed chunk extremes.
        That is a pure renaming of chunk keys — per-object key ranges stay
        separated by >= 8 keys, so run merges, commits and evictions are
        position-identical to the materialized run — which lets every
        window share one address space with no remapping.  Interval states,
        the sweep's peer-candidate order, the fused/sweep route (picked
        from the first window's mean chunk count) and phase C's origin
        queue persist across windows; per-request state is recomputed per
        window, so peak memory is bounded by the window size plus the
        capacity-bounded interval sets."""
        cfg = self.cfg
        cs = cfg.chunk_seconds
        tr_lo, tr_hi = source.tr_bounds
        c_lo = int(math.floor(tr_lo / cs))
        c_hi = int(math.ceil(tr_hi / cs)) + 1
        off = max(0, -c_lo) + 8
        span = c_hi + off + 8
        scale = 1.0 / cfg.traffic_scale
        cap = cfg.cache_bytes
        states: dict | None = None
        sweep_cands = None
        free = [0.0] * cfg.n_service_procs
        ov = cfg.origin_latency_s
        bw0 = self._bw0
        inf = float("inf")
        submit = origin_submit
        agg = OutcomeAggregate()
        origin_requests = 0
        n_total = 0
        pos0 = 0
        # adaptive block sizing persists across window edges, so a churn
        # regime discovered in one window is not re-learned in the next
        blk_state: dict = {}
        for window in source.windows():
            arr = requests_to_arrays(window)
            n_req = len(arr)
            now_arr = arr.ts * scale
            first, n_chunks = chunk_bounds_bulk(
                arr.tr_start, np.minimum(arr.tr_end, now_arr), cs)
            zero = (n_chunks == 0) | (arr.size_bytes == 0)
            k_eff = np.where(zero, 0, n_chunks)
            per_chunk = np.maximum(1, arr.size_bytes // np.maximum(1, n_chunks))
            dtn_arr = arr.continent + 1
            live = np.nonzero(k_eff > 0)[0]
            if len(live):
                if (int(first[live].min()) < c_lo
                        or int((first + k_eff)[live].max()) > c_hi):
                    raise ValueError(
                        "streaming source emitted a chunk range outside its "
                        "tr_bounds hint")
            if states is None:
                n_live = len(live)
                mean_k = (float(k_eff[live].sum()) / n_live) if n_live else 0.0
                fused = mean_k < self.SWEEP_MIN_CHUNKS_PER_REQ
                cls = FlatIntervalState if fused else IntervalLRUState
                states = {d: cls(cap)
                          for d in range(1, self.n_dtn)}
                self.caches = states
                if not fused:
                    sweep_cands = _peer_cands(self.bw, self.n_dtn)
            base = arr.obj * span + first + off
            lo_a = base[live]
            nh_full = np.zeros(n_req, np.int64)
            o_peer = np.zeros(n_req, np.int64)
            o_pt = np.zeros(n_req, np.float64)
            n_still = np.zeros(n_req, np.int64)
            if sweep_cands is None:
                nh_l, acc_l, pdt_l, still_l, _ = _fused_block_replay(
                    states, self.bw, cfg.enable_peer_cache,
                    pos0 + live, dtn_arr[live], arr.obj[live], lo_a,
                    lo_a + k_eff[live], per_chunk[live], ctr=self._ctr,
                    blk_state=blk_state)
                nh_full[live] = nh_l
                o_peer[live] = acc_l * per_chunk[live]
                o_pt[live] = pdt_l
                tra = nh_full * (per_chunk / self._ulink)
                tra[live] += pdt_l
                n_still[live] = still_l
            else:
                peer_ranges: list = []   # window-local, dropped (bounded mem)
                nh_l, miss_pos, miss_acc, miss_pdt, miss_still = _sweep_serve(
                    states, sweep_cands, cfg.enable_peer_cache,
                    dtn_arr[live].tolist(), arr.obj[live].tolist(),
                    lo_a.tolist(), k_eff[live].tolist(),
                    per_chunk[live].tolist(), (pos0 + live).tolist(),
                    peer_ranges)
                nh_full[live] = nh_l
                tra = nh_full * (per_chunk / self._ulink)
                if miss_pos:
                    midx = live[miss_pos]
                    o_peer[midx] = (np.asarray(miss_acc, np.int64)
                                    * per_chunk[midx])
                    o_pt[midx] = miss_pdt
                    tra[midx] += miss_pdt
                    n_still[midx] = miss_still
            # phase C against the persistent origin queue: the submit
            # sequence is the trace-order (now, duration) sequence, so
            # per-window replay is arithmetic-identical to whole-trace
            o_lat = np.zeros(n_req, np.float64)
            o_org = np.zeros(n_req, np.int64)
            nz = np.nonzero(n_still)[0]
            if len(nz):
                lat_l: list[float] = []
                dtr_l: list[float] = []
                ob_l = (per_chunk[nz] * n_still[nz]).tolist()
                for now, d, ob in zip(now_arr[nz].tolist(),
                                      dtn_arr[nz].tolist(), ob_l):
                    b = bw0[d]
                    start, end = submit(free, ov, now,
                                        ob / b if b > 0.0 else inf)
                    lat_l.append(start - now)
                    dtr_l.append(end - start)
                o_lat[nz] = lat_l
                tra[nz] += dtr_l
                o_org[nz] = per_chunk[nz] * n_still[nz]
            o_loc = nh_full * per_chunk
            o_bytes = np.where(zero, 0, arr.size_bytes)
            agg.add_columns(o_bytes, o_lat, tra, o_loc,
                            np.zeros(n_req, np.int64), o_peer, o_org, o_pt)
            origin_requests += int((o_org > 0).sum())
            n_total += n_req
            pos0 += n_req
        if states is None:
            states = {d: IntervalLRUState(cap)
                      for d in range(1, self.n_dtn)}
            self.caches = states
        stats = {d: st.to_cache_stats() for d, st in states.items()}
        return SimResult(
            name=name or self.pf.name,
            outcomes=[],
            origin_requests=origin_requests,
            total_requests=n_total,
            prefetch_issued_chunks=0,
            prefetch_used_chunks=0,
            cache_stats=stats,
            stream_pushes=0,
            aggregate=agg,
            evict_plan_calls=self._ctr["plan"],
            block_truncations=self._ctr["trunc"],
            degenerate_serves=self._ctr["degen"],
            block_phases=self._ctr["phases"],
            inblock_victims=self._ctr["invict"],
        )

    # -- global fused block replay (coarse-regime default) -------------------

    def _run_fused(self, P: dict) -> dict:
        """Replay the whole trace through :func:`_fused_block_replay`: the
        vector engine's block discipline (snapshot + truncation) executed
        on interval state, with run-level peer resolution and commits."""
        cfg = self.cfg
        n_req = P["n_req"]
        live = np.nonzero(~P["zero"])[0]
        lo_a = P["base"][live]
        cap = cfg.cache_bytes
        states = {d: FlatIntervalState(cap)
                  for d in range(1, self.n_dtn)}
        nh_l, acc_l, pdt_l, still_l, peer_ranges = _fused_block_replay(
            states, self.bw, cfg.enable_peer_cache,
            live, P["dtn"][live], P["obj"][live], lo_a,
            lo_a + P["k_eff"][live], P["pc"][live], ctr=self._ctr)
        per_chunk = P["pc"]
        nh_full = np.zeros(n_req, np.int64)
        nh_full[live] = nh_l
        o_peer = np.zeros(n_req, np.int64)
        o_peer[live] = acc_l * P["pc"][live]
        o_pt = np.zeros(n_req, np.float64)
        o_pt[live] = pdt_l
        tra = nh_full * (per_chunk / self._ulink)
        tra[live] += pdt_l
        n_still_arr = np.zeros(n_req, np.int64)
        n_still_arr[live] = still_l
        stats = {d: st.to_cache_stats() for d, st in states.items()}
        self.caches = states
        return dict(nh=nh_full, tra=tra, o_peer=o_peer, o_pt=o_pt,
                    n_still=n_still_arr, stats=stats,
                    peer_ranges=peer_ranges)

    # -- sequential global sweep (inline peer resolution; always exact) ------

    def _run_sweep(self, P: dict) -> dict:
        """Replay the whole trace in order, one DTN cache state per DTN:
        hit/miss split and LRU touch by interval intersection, peer fetch
        ranges resolved *inline* against the other caches' current coverage
        (so the reference's peer-before-origin insert order is applied
        exactly, with no audit needed), origin-queue submits deferred to a
        trace-order replay after the sweep."""
        cfg = self.cfg
        n_req = P["n_req"]
        live = np.nonzero(~P["zero"])[0]
        idx_l = live.tolist()
        dtn_l = P["dtn"][live].tolist()
        obj_l = P["obj"][live].tolist()
        lo_l = P["base"][live].tolist()
        k_l = P["k_eff"][live].tolist()
        pc_l = P["pc"][live].tolist()
        cap = cfg.cache_bytes
        states = {d: IntervalLRUState(cap)
                  for d in range(1, self.n_dtn)}
        cands = _peer_cands(self.bw, self.n_dtn)
        peer_ranges: list[tuple] = []
        nh_l, miss_pos, miss_acc, miss_pdt, miss_still = _sweep_serve(
            states, cands, cfg.enable_peer_cache, dtn_l, obj_l, lo_l, k_l,
            pc_l, idx_l, peer_ranges)
        per_chunk = P["pc"]
        nh_full = np.zeros(n_req, np.int64)
        nh_full[live] = nh_l
        o_peer = np.zeros(n_req, np.int64)
        o_pt = np.zeros(n_req, np.float64)
        tra = nh_full * (per_chunk / self._ulink)
        n_still_arr = np.zeros(n_req, np.int64)
        if miss_pos:
            midx = live[miss_pos]
            o_peer[midx] = np.asarray(miss_acc, np.int64) * per_chunk[midx]
            o_pt[midx] = miss_pdt
            tra[midx] += miss_pdt
            n_still_arr[midx] = miss_still
        stats = {d: st.to_cache_stats() for d, st in states.items()}
        self.caches = states
        return dict(nh=nh_full, tra=tra, o_peer=o_peer, o_pt=o_pt,
                    n_still=n_still_arr, stats=stats,
                    peer_ranges=peer_ranges)

    # -- phase C + result assembly -------------------------------------------

    def _finish(self, P: dict, out: dict, name: str) -> SimResult:
        """Sequential origin-queue replay in trace order (identical float
        arithmetic to the reference) and :class:`SimResult` assembly."""
        cfg = self.cfg
        n_req = P["n_req"]
        now_arr = P["now"]
        per_chunk = P["pc"]
        dtn_arr = P["dtn"]
        n_still = out["n_still"]
        tra = out["tra"]
        o_lat = np.zeros(n_req, np.float64)
        o_org = np.zeros(n_req, np.int64)
        nz = np.nonzero(n_still)[0]
        if len(nz):
            free = [0.0] * cfg.n_service_procs
            ov = cfg.origin_latency_s
            bw0 = self._bw0
            inf = float("inf")
            submit = origin_submit
            lat_l: list[float] = []
            dtr_l: list[float] = []
            ob_l = (per_chunk[nz] * n_still[nz]).tolist()
            for now, d, ob in zip(now_arr[nz].tolist(),
                                  dtn_arr[nz].tolist(), ob_l):
                b = bw0[d]
                start, end = submit(free, ov, now,
                                    ob / b if b > 0.0 else inf)
                lat_l.append(start - now)
                dtr_l.append(end - start)
            o_lat[nz] = lat_l
            tra[nz] += dtr_l
            o_org[nz] = per_chunk[nz] * n_still[nz]
        self.last_peer_fetches = out["peer_ranges"]
        o_loc = out["nh"] * per_chunk
        arr = P["arr"]
        o_bytes = np.where(P["zero"], 0, arr.size_bytes)
        outcomes = _LazyOutcomes((
            now_arr, arr.user_id, o_bytes, o_lat, tra, o_loc,
            np.zeros(n_req, np.int64), out["o_peer"], o_org, out["o_pt"]))
        return SimResult(
            name=name or self.pf.name,
            outcomes=outcomes,
            origin_requests=int((o_org > 0).sum()),
            total_requests=n_req,
            prefetch_issued_chunks=0,
            prefetch_used_chunks=0,
            cache_stats=out["stats"],
            stream_pushes=0,
            evict_plan_calls=self._ctr["plan"],
            block_truncations=self._ctr["trunc"],
            degenerate_serves=self._ctr["degen"],
            block_phases=self._ctr["phases"],
            inblock_victims=self._ctr["invict"],
        )


def _peer_cands(bw: np.ndarray, n_dtn: int) -> dict[int, list]:
    """Peer candidates per DTN, best-first: sorted by (-bw, id) a greedy
    first-holder assignment equals the reference's max-bw/lowest-id rule;
    peers that cannot beat the origin link are pruned outright."""
    cands: dict[int, list] = {}
    for d in range(1, n_dtn):
        ob = float(bw[0, d])
        cl = [(float(bw[d2, d]), d2) for d2 in range(1, n_dtn)
              if d2 != d and float(bw[d2, d]) > ob
              and float(bw[d2, d]) > 0.0]
        cl.sort(key=lambda t: (-t[0], t[1]))
        cands[d] = cl
    return cands


def _sweep_serve(states: dict, cands: dict, enable_peer: bool,
                 dtn_l: list, obj_l: list, lo_l: list, k_l: list,
                 pc_l: list, idx_l: list, peer_ranges: list):
    """Serve one run of live requests through the interval sweep: hit/miss
    split and LRU touch by interval intersection, peer fetch ranges
    resolved inline against the other caches' current coverage (the
    reference's peer-before-origin insert order, applied exactly).
    Mutates ``states`` and appends accepted transfers to ``peer_ranges``;
    returns per-request hit counts plus the miss-row columns."""
    nh_l: list[int] = []
    miss_pos: list[int] = []
    miss_acc: list[int] = []
    miss_pdt: list[float] = []
    miss_still: list[int] = []
    for pos, (d, o, lo, kk, pc) in enumerate(
            zip(dtn_l, obj_l, lo_l, k_l, pc_l)):
        st = states[d]
        nh, miss = st.lookup_touch(o, lo, lo + kk, pc)
        nh_l.append(nh)
        if not miss:
            continue
        ridx = idx_l[pos]
        n_acc = 0
        peer_dt = 0.0
        if enable_peer:
            unassigned = miss
            acc_runs: list[tuple[int, int]] = []
            for bwv, d2 in cands[d]:
                if not unassigned:
                    break
                cov_of = states[d2].coverage_runs
                rem: list[tuple[int, int]] = []
                for a, b in unassigned:
                    p2 = a
                    for s, e in cov_of(o, a, b):
                        if s > p2:
                            rem.append((p2, s))
                        acc_runs.append((s, e))
                        n_acc += e - s
                        peer_dt += (e - s) * (pc / bwv)
                        peer_ranges.append(
                            PeerFetchRange(ridx, d, d2, s, e))
                        p2 = e
                    if p2 < b:
                        rem.append((p2, b))
                unassigned = rem
            if acc_runs:
                acc_runs.sort()
                st.insert_runs(o, acc_runs, pc, ridx)
            still = unassigned
        else:
            still = miss
        n_still = 0
        if still:
            n_still = sum(b - a for a, b in still)
            st.insert_runs(o, still, pc, ridx)
        miss_pos.append(pos)
        miss_acc.append(n_acc)
        miss_pdt.append(peer_dt)
        miss_still.append(n_still)
    return nh_l, miss_pos, miss_acc, miss_pdt, miss_still
