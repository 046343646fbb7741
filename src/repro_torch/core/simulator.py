"""Discrete-event simulator of the VDC cyberinfrastructure (paper §V-A1).

Topology (Fig 7): seven geographically distributed DTNs on a WAN.  DTN#0 is
the VDC server (observatory access point) hosting the pre-fetching engine and
data-placement manager; DTN#1..#6 are client DTNs — one per continent — that
collectively form the distributed cache layer.  Users connect to their local
DTN at 100 Gbps.

Origin service model: a task queue with ``n_service_procs`` (10) service
processes; requests that reach the observatory queue for the next free
process.  *Latency* = time from request submission until the observatory
starts processing it (queue wait).  *Throughput* = request bytes / total
transfer time.

Resolution order for a user request (paper §IV-D): local DTN cache → peer
DTN caches (fetch from peer iff its link beats the origin's) → origin.
Pre-fetch transfers go through the same origin queue (they consume service
capacity — being *early* is their only advantage, as in the paper).
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import typing
from typing import Sequence

import numpy as np

from repro_torch.core.cache import (Cache, CacheStats, chunk_bytes, chunks_for_range,
                              make_cache)
from repro_torch.core.delivery import Prefetcher
from repro_torch.core.hpm import PrefetchOp
from repro_torch.core.placement import PlacementEngine
from repro_torch.core.streaming import StreamingEngine
from repro_torch.core.trace import ObjectGrid, Request, StreamingRequestSource
from repro_torch.device import resolve_device

GBPS = 1e9 / 8  # bytes per second per Gbps

# Interconnect bandwidths (Gbps), Fig 8-style heterogeneous WAN.  Row i /
# col j = link DTN_i -> DTN_j.  DTN#0 = the observatory-side server: the
# VDC premise is that the regional DTN mesh is FAST while the shared-use
# observatory sits behind a slower WAN uplink — peer DTN fetches often beat
# origin fetches, which is what gives the cache network and the placement
# strategy their value (paper §II-B, Fig 8).  Client links span the
# 4-25 Gbps range to mirror the Fig 2 continental asymmetry.
DEFAULT_BANDWIDTH_GBPS = np.array(
    [
        #  srv   NA    AS    EU    SA    AF    OC
        [0.0, 15.0, 4.0, 8.0, 6.0, 4.0, 6.0],        # server ->
        [15.0, 0.0, 12.0, 25.0, 18.0, 10.0, 20.0],   # NA ->
        [4.0, 12.0, 0.0, 12.0, 8.0, 8.0, 14.0],      # Asia ->
        [8.0, 25.0, 12.0, 0.0, 14.0, 12.0, 14.0],    # Europe ->
        [6.0, 18.0, 8.0, 14.0, 0.0, 8.0, 8.0],       # S.America ->
        [4.0, 10.0, 8.0, 12.0, 8.0, 0.0, 8.0],       # Africa ->
        [6.0, 20.0, 14.0, 14.0, 8.0, 8.0, 0.0],      # Oceania ->
    ]
)

USER_LINK_GBPS = 100.0


@dataclasses.dataclass
class SimConfig:
    """Configuration of one VDC replay (shared verbatim by all three
    engines — reference, vector, interval — which is what makes their
    counter-equivalence contract meaningful; see
    ``tests/test_torch_engine_interval.py`` and ``docs/ARCHITECTURE.md``).

    Fields are grouped as: cache layer (policy/budget/chunking), WAN and
    origin service model (paper §V-A1), and the engine execution knob
    ``batched_prediction``, which changes *how* a result is computed but
    never *what* it is.
    """

    cache_policy: str = "lru"
    cache_bytes: int = 128 << 30
    n_service_procs: int = 10
    bandwidth_scale: float = 1.0          # 1.0=best, 0.5=medium, 0.01=worst
    traffic_scale: float = 1.0            # >1 compresses time (heavy traffic)
    chunk_seconds: float = 3600.0
    stream_rate_bytes_per_s: float = 8e3  # must match the trace profile
    enable_peer_cache: bool = True
    enable_placement: bool = True
    placement_period: float = 7 * 24 * 3600.0
    # Fixed origin service time per request.  The synthetic traces subsample
    # the real user population (17.9M-77.8M requests), so this constant
    # emulates the load the *full* population puts on the observatory's ten
    # service processes.  Use :meth:`calibrate_origin` to set it from a
    # target utilization at regular traffic.
    origin_latency_s: float = 2.0
    bandwidth_gbps: np.ndarray | None = None
    # Vector engine only: pre-compute the whole-trace prediction plan through
    # the prefetcher's batched planner (two-phase HPM: ARIMA bank kernel +
    # memoized rules) instead of calling ``observe`` per request.  Emits the
    # identical op stream (tests/test_torch_hpm.py); set False to force
    # the online path, e.g. for benchmarking the prediction layer itself.
    # The reference simulator always replays online.
    batched_prediction: bool = True

    def calibrate_origin(self, requests: Sequence["Request"],
                         target_utilization: float = 0.2) -> "SimConfig":
        """Set origin_latency_s so the origin queue runs at
        ``target_utilization`` when every request hits the origin at regular
        traffic (the paper's W/O-cache regime)."""
        if not requests:
            return self
        span = max(1.0, requests[-1].ts - requests[0].ts)
        rate = len(requests) / span * self.traffic_scale
        self.origin_latency_s = target_utilization * self.n_service_procs / rate
        return self


class RequestOutcome(typing.NamedTuple):
    # NamedTuple (not a dataclass): replay engines construct millions of
    # these per trace, and tuple construction is ~3x cheaper
    ts: float
    user_id: int
    bytes: int
    latency: float            # origin queue wait + overhead (0 for cache hits)
    transfer_time: float      # pure wire time
    local_bytes: int
    prefetched_bytes: int
    peer_bytes: int
    origin_bytes: int
    peer_time: float = 0.0

    @property
    def delivery_time(self) -> float:
        """End-to-end time the user waits for the data."""
        return self.latency + self.transfer_time

    @property
    def throughput_mbps(self) -> float:
        """User-perceived throughput: bytes over end-to-end delivery time
        (origin queue wait included — that is what makes uncached origin
        fetches slow in the paper's Figures 9-12)."""
        dt = self.delivery_time
        if dt <= 0:
            return 0.0
        return self.bytes * 8 / dt / 1e6


@dataclasses.dataclass
class OutcomeAggregate:
    """Running totals over :class:`RequestOutcome` columns.

    Streaming replay cannot keep the per-request outcome list (it is
    O(trace length)); it folds every window's outcomes into this instead.
    Integer fields are exact sums — the cross-engine equivalence contract
    applies to them verbatim; float sums match a materialized run up to
    summation-order rounding only.
    """

    n: int = 0
    n_bytes_pos: int = 0        # outcomes with bytes > 0 (throughput mean)
    bytes: int = 0
    local_bytes: int = 0
    prefetched_bytes: int = 0
    peer_bytes: int = 0
    origin_bytes: int = 0
    latency_sum: float = 0.0
    transfer_sum: float = 0.0
    peer_time_sum: float = 0.0
    throughput_sum: float = 0.0

    def add(self, o: "RequestOutcome") -> None:
        self.n += 1
        self.bytes += o.bytes
        self.local_bytes += o.local_bytes
        self.prefetched_bytes += o.prefetched_bytes
        self.peer_bytes += o.peer_bytes
        self.origin_bytes += o.origin_bytes
        self.latency_sum += o.latency
        self.transfer_sum += o.transfer_time
        self.peer_time_sum += o.peer_time
        if o.bytes > 0:
            self.n_bytes_pos += 1
            self.throughput_sum += o.throughput_mbps

    def add_columns(self, bytes_, lat, tra, loc, pref, peer, org, pt) -> None:
        """Fold one window of outcome columns (the engines' SoA form)."""
        bytes_ = np.asarray(bytes_)
        lat = np.asarray(lat, np.float64)
        tra = np.asarray(tra, np.float64)
        self.n += int(bytes_.shape[0])
        self.bytes += int(bytes_.sum())
        self.local_bytes += int(np.asarray(loc).sum())
        self.prefetched_bytes += int(np.asarray(pref).sum())
        self.peer_bytes += int(np.asarray(peer).sum())
        self.origin_bytes += int(np.asarray(org).sum())
        self.latency_sum += float(lat.sum())
        self.transfer_sum += float(tra.sum())
        self.peer_time_sum += float(np.asarray(pt, np.float64).sum())
        pos = bytes_ > 0
        self.n_bytes_pos += int(pos.sum())
        dt = lat + tra
        ok = pos & (dt > 0)
        thr = np.zeros(bytes_.shape[0], np.float64)
        np.divide(bytes_ * 8.0, dt, out=thr, where=ok)
        thr /= 1e6      # same per-element arithmetic as throughput_mbps
        self.throughput_sum += float(thr.sum())

    @classmethod
    def from_outcomes(cls, outcomes: "Sequence[RequestOutcome]"
                      ) -> "OutcomeAggregate":
        agg = cls()
        for o in outcomes:
            agg.add(o)
        return agg


@dataclasses.dataclass
class SimResult:
    name: str
    outcomes: list[RequestOutcome]
    origin_requests: int
    total_requests: int
    prefetch_issued_chunks: int
    prefetch_used_chunks: int
    cache_stats: dict[int, CacheStats]
    stream_pushes: int
    # Streaming replay: per-request outcomes are not retained; their totals
    # live here and the derived metrics below fall back to them.
    aggregate: "OutcomeAggregate | None" = None
    # Eviction-path telemetry (block-replay engines; 0 for the reference):
    # speculative eviction-plan calls, blocks truncated at eviction
    # pressure, and requests served through the scalar fallback.
    evict_plan_calls: int = 0
    block_truncations: int = 0
    degenerate_serves: int = 0
    # Phased block replay: mid-block eviction phases committed
    # beyond each block's first, and chunks evicted at those mid-block
    # phase boundaries (in-block victims — keys whose last remaining
    # reference preceded the boundary).
    block_phases: int = 0
    inblock_victims: int = 0

    def outcome_totals(self) -> OutcomeAggregate:
        """Outcome column totals, independent of how the trace was replayed
        (the streaming==materialized equivalence tests compare these)."""
        if self.aggregate is not None:
            return self.aggregate
        return OutcomeAggregate.from_outcomes(self.outcomes)

    @property
    def mean_throughput_mbps(self) -> float:
        if not self.outcomes and self.aggregate is not None:
            a = self.aggregate
            return a.throughput_sum / a.n_bytes_pos if a.n_bytes_pos else 0.0
        v = [o.throughput_mbps for o in self.outcomes if o.bytes > 0]
        return float(np.mean(v)) if v else 0.0

    @property
    def mean_latency_s(self) -> float:
        if not self.outcomes and self.aggregate is not None:
            a = self.aggregate
            return a.latency_sum / a.n if a.n else 0.0
        v = [o.latency for o in self.outcomes]
        return float(np.mean(v)) if v else 0.0

    @property
    def recall(self) -> float:
        if self.prefetch_issued_chunks == 0:
            return 0.0
        return self.prefetch_used_chunks / self.prefetch_issued_chunks

    @property
    def normalized_origin_requests(self) -> float:
        return self.origin_requests / max(1, self.total_requests)

    @property
    def local_access_frac(self) -> tuple[float, float]:
        """(cached_frac, prefetched_frac) of bytes served at the local DTN."""
        if not self.outcomes and self.aggregate is not None:
            a = self.aggregate
            tot = a.bytes or 1
            return a.local_bytes / tot, a.prefetched_bytes / tot
        tot = sum(o.bytes for o in self.outcomes) or 1
        cached = sum(o.local_bytes for o in self.outcomes)
        pref = sum(o.prefetched_bytes for o in self.outcomes)
        return cached / tot, pref / tot


class _OriginQueue:
    """n service processes; returns (start_time, end_time) for a job.

    User requests pay the per-request service ``overhead`` (catalog lookup,
    query processing — calibrated to emulate full-population load); bulk
    prefetch/push transfers only occupy a process for their wire time.
    """

    def __init__(self, n_procs: int, overhead: float):
        self.free_at = [0.0] * n_procs
        self.overhead = overhead

    def submit(self, now: float, duration: float,
               with_overhead: bool = True) -> tuple[float, float]:
        i = int(np.argmin(self.free_at))
        start = max(now, self.free_at[i]) + (self.overhead if with_overhead else 0.0)
        end = start + duration
        self.free_at[i] = end
        return start, end


class VDCSimulator:
    """Replay a trace through the push-based delivery framework."""

    def __init__(self, grid: ObjectGrid, prefetcher: Prefetcher,
                 config: SimConfig, use_cache: bool = True, device=None):
        self.grid = grid
        self.pf = prefetcher
        self.cfg = config
        self.use_cache = use_cache
        bw = (config.bandwidth_gbps
              if config.bandwidth_gbps is not None else DEFAULT_BANDWIDTH_GBPS)
        self.bw = bw * config.bandwidth_scale * GBPS      # bytes/s
        self.n_dtn = self.bw.shape[0]
        self.caches: dict[int, Cache] = {
            d: make_cache(config.cache_policy, config.cache_bytes)
            for d in range(1, self.n_dtn)
        }
        self.origin = _OriginQueue(config.n_service_procs, config.origin_latency_s)
        self.placement = (PlacementEngine(grid, device=device)
                          if config.enable_placement else None)
        # prefetched-chunk bookkeeping for recall: (dtn, chunk) -> used?
        self._prefetched: dict[tuple[int, tuple[int, int]], bool] = {}
        self._chunk_bytes = chunk_bytes(config.stream_rate_bytes_per_s,
                                        config.chunk_seconds)
        self._user_dtn: dict[int, int] = {}
        self._recent_requests: collections.deque[Request] = collections.deque(
            maxlen=5000)
        self._last_placement_ts = 0.0

    # -- helpers -------------------------------------------------------------

    def _dtn_of(self, r: Request) -> int:
        d = r.continent + 1
        self._user_dtn[r.user_id] = d
        return d

    def _available_chunks(self, r_or_op, now: float) -> list[tuple[int, int]]:
        obj = r_or_op.obj
        tr_end = min(r_or_op.tr_end, now)    # data exists only up to `now`
        return chunks_for_range(obj, r_or_op.tr_start, tr_end,
                                self.cfg.chunk_seconds)

    def _transfer_time(self, nbytes: int, src: int, dst: int) -> float:
        if src == dst:
            return nbytes / (USER_LINK_GBPS * GBPS)
        bw = self.bw[src, dst]
        if bw <= 0:
            return float("inf")
        return nbytes / bw

    # -- main entry ----------------------------------------------------------

    def run(self, requests: Sequence[Request], name: str = "") -> SimResult:
        if isinstance(requests, StreamingRequestSource):
            return self._run_stream(requests, name)
        cfg = self.cfg
        # traffic scaling compresses/expands the request timeline
        scale = 1.0 / cfg.traffic_scale
        events: list[tuple[float, int, str, object]] = []
        counter = itertools.count()
        for r in requests:
            heapq.heappush(events, (r.ts * scale, next(counter), "req", r))
        outcomes: list[RequestOutcome] = []
        origin_requests = 0
        stream_engine: StreamingEngine | None = getattr(self.pf, "streaming", None)

        while events:
            now, _, kind, payload = heapq.heappop(events)
            if kind == "push" and stream_engine is not None:
                self._apply_stream_push(payload)
                continue
            if kind == "prefetch":
                self._apply_prefetch(payload, now, events, counter)
                continue
            r: Request = payload
            r_scaled = dataclasses.replace(r, ts=now)
            dtn = self._dtn_of(r_scaled)
            self._recent_requests.append(r_scaled)

            # streaming absorption: active subscription serves this poll
            absorbed = bool(stream_engine and stream_engine.absorb(r_scaled))

            outcome = self._serve(r_scaled, dtn, now, absorbed)
            outcomes.append(outcome)
            if outcome.origin_bytes > 0:
                origin_requests += 1

            # pre-fetching engine observes requests that reach the server
            ops = self.pf.observe(r_scaled)
            for op in ops:
                heapq.heappush(events, (max(now, op.issue_ts), next(counter),
                                        "prefetch", op))
            # streaming pushes due by now
            if stream_engine is not None:
                for push in stream_engine.pushes_until(now):
                    heapq.heappush(events, (push.ts, next(counter), "push", push))
            # periodic placement
            if (self.placement is not None
                    and now - self._last_placement_ts >= cfg.placement_period):
                self._run_placement(now)
                self._last_placement_ts = now

        used = sum(1 for v in self._prefetched.values() if v)
        return SimResult(
            name=name or self.pf.name,
            outcomes=outcomes,
            origin_requests=origin_requests,
            total_requests=len(outcomes),
            prefetch_issued_chunks=len(self._prefetched),
            prefetch_used_chunks=used,
            cache_stats={d: c.stats for d, c in self.caches.items()},
            stream_pushes=stream_engine.pushes_emitted if stream_engine else 0,
        )

    def _run_stream(self, source: StreamingRequestSource,
                    name: str = "") -> SimResult:
        """Windowed replay of a :class:`StreamingRequestSource` — the same
        event loop as :meth:`run` without ever heaping the full trace.

        Exactness: :meth:`run` pushes all requests up front with creation
        counters ``0..n-1``; dynamic events get counters ``>= n``, so on a
        timestamp tie a request always pops before any event, and events
        order among themselves by creation.  The merged loop below — pop
        events strictly *before* the next request's timestamp, serve the
        request, then drain — reproduces exactly that order, so outcomes
        are identical; only their storage differs (folded into
        :class:`OutcomeAggregate` instead of a per-request list).
        """
        cfg = self.cfg
        scale = 1.0 / cfg.traffic_scale
        events: list[tuple[float, int, str, object]] = []
        counter = itertools.count()
        agg = OutcomeAggregate()
        origin_requests = 0
        stream_engine: StreamingEngine | None = getattr(self.pf, "streaming", None)

        def handle(now: float, kind: str, payload) -> None:
            if kind == "push" and stream_engine is not None:
                self._apply_stream_push(payload)
            elif kind == "prefetch":
                self._apply_prefetch(payload, now, events, counter)

        for window in source.windows():
            for r in window:
                now = r.ts * scale
                while events and events[0][0] < now:
                    ev_now, _, kind, payload = heapq.heappop(events)
                    handle(ev_now, kind, payload)
                r_scaled = dataclasses.replace(r, ts=now)
                dtn = self._dtn_of(r_scaled)
                self._recent_requests.append(r_scaled)
                absorbed = bool(stream_engine and stream_engine.absorb(r_scaled))
                outcome = self._serve(r_scaled, dtn, now, absorbed)
                agg.add(outcome)
                if outcome.origin_bytes > 0:
                    origin_requests += 1
                ops = self.pf.observe(r_scaled)
                for op in ops:
                    heapq.heappush(events, (max(now, op.issue_ts),
                                            next(counter), "prefetch", op))
                if stream_engine is not None:
                    for push in stream_engine.pushes_until(now):
                        heapq.heappush(events,
                                       (push.ts, next(counter), "push", push))
                if (self.placement is not None
                        and now - self._last_placement_ts >= cfg.placement_period):
                    self._run_placement(now)
                    self._last_placement_ts = now
        while events:
            ev_now, _, kind, payload = heapq.heappop(events)
            handle(ev_now, kind, payload)

        used = sum(1 for v in self._prefetched.values() if v)
        return SimResult(
            name=name or self.pf.name,
            outcomes=[],
            origin_requests=origin_requests,
            total_requests=agg.n,
            prefetch_issued_chunks=len(self._prefetched),
            prefetch_used_chunks=used,
            cache_stats={d: c.stats for d, c in self.caches.items()},
            stream_pushes=stream_engine.pushes_emitted if stream_engine else 0,
            aggregate=agg,
        )

    # -- serving -------------------------------------------------------------

    def _serve(self, r: Request, dtn: int, now: float,
               absorbed: bool) -> RequestOutcome:
        chunks = self._available_chunks(r, now)
        nbytes = r.size_bytes
        if not chunks or nbytes == 0:
            return RequestOutcome(now, r.user_id, 0, 0.0, 0.0, 0, 0, 0, 0)
        per_chunk = max(1, nbytes // len(chunks))
        local_b = pref_b = peer_b = origin_b = 0
        transfer = 0.0
        latency = 0.0
        cache = self.caches[dtn] if self.use_cache else None
        missing: list[tuple[int, int]] = []
        for ck in chunks:
            if cache is not None and cache.lookup(ck, per_chunk):
                key = (dtn, ck)
                if key in self._prefetched and not self._prefetched[key]:
                    self._prefetched[key] = True
                    pref_b += per_chunk
                else:
                    local_b += per_chunk
                transfer += per_chunk / (USER_LINK_GBPS * GBPS)
            else:
                missing.append(ck)
        # peer lookup for missing chunks
        still_missing: list[tuple[int, int]] = []
        peer_t = 0.0
        if missing and self.cfg.enable_peer_cache and self.use_cache:
            for ck in missing:
                src = self._find_peer(ck, dtn)
                if src is not None and self.bw[src, dtn] > self.bw[0, dtn]:
                    peer_b += per_chunk
                    dt_ = self._transfer_time(per_chunk, src, dtn)
                    transfer += dt_
                    peer_t += dt_
                    if cache is not None:
                        cache.insert(ck, per_chunk)
                else:
                    still_missing.append(ck)
        else:
            still_missing = missing
        # origin for the rest (absorbed real-time polls skip the origin queue:
        # data was already pushed; treat as local once present)
        if still_missing:
            ob = per_chunk * len(still_missing)
            if absorbed:
                transfer += ob / (USER_LINK_GBPS * GBPS)
                local_b += ob
            else:
                origin_b = ob
                duration = self._transfer_time(ob, 0, dtn)
                start, end = self.origin.submit(now, duration)
                latency = start - now
                transfer += end - start
                if cache is not None:
                    for ck in still_missing:
                        cache.insert(ck, per_chunk)
        return RequestOutcome(now, r.user_id, nbytes, latency, transfer,
                              local_b, pref_b, peer_b, origin_b, peer_t)

    def _find_peer(self, ck: tuple[int, int], dtn: int) -> int | None:
        best, best_bw = None, 0.0
        for d, cache in self.caches.items():
            if d == dtn or not cache.contains(ck):
                continue
            if self.bw[d, dtn] > best_bw:
                best, best_bw = d, self.bw[d, dtn]
        return best

    # -- prefetch / push / placement -----------------------------------------

    def _apply_prefetch(self, op: PrefetchOp, now: float, events, counter) -> None:
        if not self.use_cache:
            return
        dtn = self._user_dtn.get(op.user_id)
        if dtn is None:
            return
        chunks = self._available_chunks(op, now)
        # pre-fetch can only ship *finalized* chunks (the live tail of a
        # stream is the streaming mechanism's job, not the prefetcher's)
        chunks = [ck for ck in chunks
                  if (ck[1] + 1) * self.cfg.chunk_seconds <= now]
        if not chunks:
            return
        cache = self.caches[dtn]
        new_chunks = [ck for ck in chunks if not cache.contains(ck)]
        if not new_chunks:
            return
        nbytes = self._chunk_bytes * len(new_chunks)
        duration = self._transfer_time(nbytes, 0, dtn)
        self.origin.submit(now, duration, with_overhead=False)
        for ck in new_chunks:
            cache.insert(ck, self._chunk_bytes)
            self._prefetched.setdefault((dtn, ck), False)

    def _apply_stream_push(self, push) -> None:
        if not self.use_cache:
            return
        chunks = chunks_for_range(push.obj, push.tr_start, push.tr_end,
                                  self.cfg.chunk_seconds)
        if not chunks:
            # sub-chunk push: still mark the covering chunk
            chunks = chunks_for_range(push.obj, push.tr_start,
                                      push.tr_start + self.cfg.chunk_seconds,
                                      self.cfg.chunk_seconds)
        nbytes = int((push.tr_end - push.tr_start)
                     * self.cfg.stream_rate_bytes_per_s)
        # one origin transfer serves all subscribed DTNs (request combining)
        self.origin.submit(push.ts, self._transfer_time(nbytes, 0, push.dtns[0])
                           if push.dtns else 0.0, with_overhead=False)
        for d in push.dtns:
            if d in self.caches:
                for ck in chunks:
                    self.caches[d].insert(ck, max(1, nbytes // len(chunks)))
                    self._prefetched.setdefault((d, ck), False)

    def _run_placement(self, now: float) -> None:
        if not self._recent_requests or not self.use_cache:
            return
        util = {d: 1.0 - c.used / max(1, c.capacity)
                for d, c in self.caches.items()}
        groups = self.placement.recluster(
            list(self._recent_requests), self._user_dtn,
            self.bw / GBPS, util,
        )
        # replicate each group's hot objects' most recent chunks to its hub
        # (from a peer when one holds them, else from the origin — "keep hot
        # data in the cache network as long as possible", §IV-C2)
        for g in groups:
            hub = g.hub_dtn
            if hub not in self.caches:
                continue
            for obj in g.hot_objs:
                recent = chunks_for_range(obj, max(0.0, now - 24 * 3600.0), now,
                                          self.cfg.chunk_seconds)
                new = [ck for ck in recent[-4:]
                       if not self.caches[hub].contains(ck)]
                for ck in new:
                    src = self._find_peer(ck, hub)
                    if src is None:
                        self.origin.submit(
                            now, self._transfer_time(self._chunk_bytes, 0, hub),
                            with_overhead=False)
                    self.caches[hub].insert(ck, self._chunk_bytes)
                    self._prefetched.setdefault((hub, ck), False)


def run_strategy(
    strategy: str,
    requests: Sequence[Request],
    grid: ObjectGrid,
    config: SimConfig,
    training_requests: Sequence[Request] | None = None,
    engine: str = "vector",
    device=None,
) -> SimResult:
    """Run one named strategy: no_cache | cache_only | md1 | md2 | hpm.

    ``engine`` selects the replay implementation (all three are pinned to
    identical integer counters by ``tests/test_torch_engine.py`` and
    ``tests/test_torch_engine_interval.py``; see ``docs/ARCHITECTURE.md``
    for the layer map):

    - ``"vector"`` (default): the array-backed batch-replay engine
      (:mod:`repro_torch.core.engine`) — same results, 1-2 orders of
      magnitude faster on the serving hot path.  For prefetchers that
      support it (hpm), prediction runs in batch mode: the whole-trace op
      stream is planned up front through the ARIMA bank kernel
      (``config.batched_prediction``, on by default).
    - ``"interval"``: interval-algebra presence tracking for static LRU
      serving (cache_only), through a fused block replay for coarse chunks
      and a per-request sweep for fine ones; dynamic strategies and LFU
      delegate to the vector machinery.  The only engine whose per-request
      cost is independent of the chunk resolution.
    - ``"reference"``: the per-chunk dict/heap :class:`VDCSimulator` above —
      the readable semantic baseline the other engines are verified
      against, always predicting online via per-request ``observe``.

    ``device`` (CUDA by default) is where the ARIMA fits and the placement
    k-means run; asking for CUDA where there is none raises.
    """
    from repro_torch.core.delivery import make_prefetcher

    device = resolve_device(device)
    if engine not in ("reference", "vector", "interval"):
        raise ValueError(f"unknown engine: {engine!r}")
    pf = make_prefetcher(strategy, grid, training_requests, device=device)
    use_cache = strategy != "no_cache"
    # "Cache Only" is the paper's no-optimization baseline: a cache layer
    # but no pre-fetching AND no placement strategy
    if strategy in ("no_cache", "cache_only"):
        config = dataclasses.replace(config, enable_placement=False)
    if engine == "reference":
        sim = VDCSimulator(grid, pf, config, use_cache=use_cache,
                           device=device)
    elif engine == "vector":
        from repro_torch.core.engine import VectorVDCSimulator

        sim = VectorVDCSimulator(grid, pf, config, use_cache=use_cache,
                                 device=device)
    else:
        from repro_torch.core.engine import IntervalVDCSimulator

        sim = IntervalVDCSimulator(grid, pf, config, use_cache=use_cache,
                                   device=device)
    return sim.run(requests, name=strategy)
