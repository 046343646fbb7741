"""Push-based delivery framework: prefetcher adapters (paper §IV, §V-A2).

The simulator (:mod:`repro_torch.core.simulator`) drives one of these adapters.
Each adapter observes the request stream arriving at the server-side DTN and
emits :class:`repro_torch.core.hpm.PrefetchOp` plans.  Adapters:

- ``NoPrefetch``       — cache-only baseline ("Cache Only") or no-cache.
- ``HPMAdapter``       — the paper's hybrid model (history + rules + stream).
- ``MD1Adapter``       — Li et al. Markov popularity model (all requests).
- ``MD2Adapter``       — Xiong et al. mesh association rules + ARIMA.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Protocol, Sequence

import numpy as np

from repro_torch.core.hpm import (BatchedHPMPlanner, HybridPrefetcher, PrefetchOp,
                            build_rule_transactions)
from repro_torch.core.markov import MarkovPredictor
from repro_torch.core.mining import MeshRulePredictor
from repro_torch.core.streaming import StreamingEngine
from repro_torch.core.trace import ObjectGrid, Request
from repro_torch.device import resolve_device


class Prefetcher(Protocol):
    name: str

    def observe(self, r: Request) -> list[PrefetchOp]: ...


@dataclasses.dataclass(frozen=True)
class PlannedPrediction:
    """Whole-trace prediction plan: for request ``i``, the non-stream ops to
    schedule (``ops[i]``) and the streaming subscriptions to register
    (``subscriptions[i]``, args of :meth:`StreamingEngine.subscribe`) — the
    exact side effects ``observe`` would have produced at that request."""

    ops: list[Sequence[PrefetchOp]]
    subscriptions: list[Sequence[tuple]]


class NoPrefetch:
    name = "none"
    # never emits ops nor streams: the vectorized engine may replay whole
    # request blocks at once instead of walking the event loop
    static = True

    def observe(self, r: Request) -> list[PrefetchOp]:
        return []


def _stream_subscription(r: Request, op: PrefetchOp) -> tuple:
    """``StreamingEngine.subscribe`` args for a model "stream" op — ONE
    definition for the online and batch paths (part of the op-for-op
    equivalence contract)."""
    return (r.user_id, r.continent + 1, r.obj,
            max(1.0, op.tr_end - op.tr_start), r.ts)


class HPMAdapter:
    """The paper's Hybrid Pre-fetching Model."""

    name = "hpm"

    def __init__(self, training_requests: Sequence[Request] | None = None,
                 min_support: int = 30, min_confidence: float = 0.5,
                 offset: float = 0.8, device=None):
        txs = build_rule_transactions(training_requests) if training_requests else None
        self.model = HybridPrefetcher(
            rule_transactions=txs, min_support=min_support,
            min_confidence=min_confidence, offset=offset, device=device,
        )
        self.streaming = StreamingEngine()

    def observe(self, r: Request) -> list[PrefetchOp]:
        ops = self.model.observe(r)
        out = []
        for op in ops:
            if op.reason == "stream":
                self.streaming.subscribe(*_stream_subscription(r, op))
            else:
                out.append(op)
        return out

    def plan(self, requests: Sequence[Request]) -> PlannedPrediction:
        """Batch mode: pre-compute the whole-trace prediction plan through
        the two-phase planner (ARIMA bank kernel, memoized rules).  Emits
        exactly what per-request :meth:`observe` calls would — ops op-for-op
        and subscriptions at the same request positions — without mutating
        the online model's state."""
        if self.model.users:
            # the planner replays classification from scratch; planning on
            # top of observe()-accumulated state would silently diverge
            raise RuntimeError(
                "plan() requires an unobserved model: this adapter already "
                "processed requests via observe()")
        per_req = BatchedHPMPlanner(self.model).plan(requests)
        return _route_planned_ops(requests, per_req)

    def planner(self) -> "HPMWindowPlanner":
        """Window mode: a stateful planner whose ``plan_window`` calls may
        split the trace at arbitrary points (``BatchedHPMPlanner`` carries
        per-user classification state across windows; any split emits the
        identical op stream).  Same fresh-model precondition as
        :meth:`plan`."""
        if self.model.users:
            raise RuntimeError(
                "planner() requires an unobserved model: this adapter "
                "already processed requests via observe()")
        return HPMWindowPlanner(BatchedHPMPlanner(self.model))


def _route_planned_ops(requests: Sequence[Request],
                       per_req: Sequence[Sequence[PrefetchOp]]
                       ) -> PlannedPrediction:
    """Route a planner's per-request op lists the way ``observe`` does:
    stream ops become subscriptions, everything else is scheduled as a
    prefetch.  ONE definition for whole-trace and windowed planning."""
    ops: list[Sequence[PrefetchOp]] = []
    subs: list[Sequence[tuple]] = []
    empty: tuple = ()
    for r, req_ops in zip(requests, per_req):
        if not req_ops:
            ops.append(empty)
            subs.append(empty)
            continue
        r_subs = [_stream_subscription(r, op) for op in req_ops
                  if op.reason == "stream"]
        r_ops = [op for op in req_ops if op.reason != "stream"]
        ops.append(r_ops or empty)
        subs.append(r_subs or empty)
    return PlannedPrediction(ops=ops, subscriptions=subs)


class HPMWindowPlanner:
    """Per-window prediction plans over a stateful :class:`BatchedHPMPlanner`
    (streaming replay: plan storage is flushed per window)."""

    def __init__(self, planner: BatchedHPMPlanner):
        self._planner = planner

    def plan_window(self, requests: Sequence[Request]) -> PlannedPrediction:
        return _route_planned_ops(requests,
                                  self._planner.plan_window(requests))


class MD1Adapter:
    """Li et al. Markov popularity model.  Object prediction is a Markov
    chain over the location access path + popularity; Li et al. pre-fetch
    *on access* (no temporal model — that is MD2's and HPM's edge)."""

    name = "md1"

    def __init__(self, grid: ObjectGrid,
                 training_requests: Sequence[Request] | None = None,
                 top_n: int = 3):
        self.model = MarkovPredictor(grid)
        if training_requests:
            self.model.fit(training_requests)
        self.top_n = top_n

    def observe(self, r: Request) -> list[PrefetchOp]:
        objs = self.model.predict_next_objs(r, self.top_n)
        self.model.observe(r)
        width = max(1.0, r.tr_end - r.tr_start)
        # prefetch-on-access: most recent `width` of the predicted objects
        return [
            PrefetchOp(r.ts, r.user_id, obj, r.ts - width, r.ts, "markov")
            for obj in objs
        ]


class MD2Adapter:
    name = "md2"

    def __init__(self, grid: ObjectGrid,
                 training_requests: Sequence[Request] | None = None,
                 top_n: int = 3, device=None):
        self.model = MeshRulePredictor(grid, device=device)
        if training_requests:
            self.model.fit(training_requests)
        self.top_n = top_n

    def observe(self, r: Request) -> list[PrefetchOp]:
        plan = self.model.predict(r, self.top_n)
        self.model.observe(r)
        # issue at the same offset fraction of the predicted gap as HPM
        out = []
        for obj, ts, s, e in plan:
            issue = r.ts + 0.8 * max(0.0, ts - r.ts)
            out.append(PrefetchOp(issue, r.user_id, obj, s, e, "mining"))
        return out


# ---------------------------------------------------------------------------
# Peer-fetch resolution (paper §IV-D) — shared by the replay engines
# ---------------------------------------------------------------------------


def select_peer_sources(bw_to_dtn: np.ndarray, holders: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Resolve peer sources for a batch of missing chunks (paper §IV-D).

    ``bw_to_dtn[s]`` is the link bandwidth from DTN ``s`` into the requesting
    DTN (``bw_to_dtn[0]`` = the origin link); ``holders[s, c]`` says whether
    DTN ``s`` holds missing chunk ``c`` at request time.  The caller must
    already have cleared the origin row and the requesting DTN's own row.

    Returns ``(src, accepted)``: the chosen peer per chunk (max bandwidth,
    ties to the lowest DTN id — the reference simulator iterates DTNs
    ascending keeping strict improvements) and whether the fetch is accepted
    (the peer link strictly beats the origin link; §IV-D resolution order).
    ``src`` is only meaningful where ``accepted``.
    """
    n = holders.shape[1]
    scores = np.where(holders, bw_to_dtn[:, None], -1.0)
    src = np.argmax(scores, axis=0)
    accepted = (scores[src, np.arange(n)] > 0.0) & \
        (bw_to_dtn[src] > bw_to_dtn[0])
    return src, accepted


class PeerFetchRange(typing.NamedTuple):
    """One planned peer transfer: chunks ``[key_lo, key_hi)`` shipped from
    DTN ``src`` into DTN ``dtn`` for the request at trace position
    ``req_pos`` (dense chunk keys as used by the replay engines)."""

    req_pos: int
    dtn: int
    src: int
    key_lo: int
    key_hi: int


def coalesce_peer_fetches(req_pos: np.ndarray, keys: np.ndarray,
                          src: np.ndarray, dtn: int) -> list[PeerFetchRange]:
    """Group accepted per-chunk peer decisions into contiguous
    :class:`PeerFetchRange` transfers (same request, same source, adjacent
    chunk keys).  Public as in ``repro.core``, whose sharded interval
    replay builds its peer plan with it; the port's replays, which have no
    sharded mode, coalesce their ranges as they resolve them."""
    out: list[PeerFetchRange] = []
    for r, k, s in zip(req_pos.tolist(), keys.tolist(), src.tolist()):
        if out and out[-1].req_pos == r and out[-1].src == s \
                and out[-1].key_hi == k:
            out[-1] = out[-1]._replace(key_hi=k + 1)
        else:
            out.append(PeerFetchRange(r, dtn, s, k, k + 1))
    return out


def select_peer_sources_ranges(bw_col: np.ndarray, holders: np.ndarray
                               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Range-level variant of :func:`select_peer_sources` for the fused
    block replay: resolve peer sources for a batch of missing key *runs*
    that may belong to requests on different DTNs.

    ``bw_col[s, c]`` is the link bandwidth from DTN ``s`` into run ``c``'s
    requesting DTN (column ``bw[:, dtn_of_run]`` of the link matrix, so row
    0 is each run's origin link); ``holders[s, c]`` says whether DTN ``s``
    holds run ``c`` in full at the run's serve time — the engine derives it
    from each cache's block-start presence snapshot (``coverage_arrays``;
    on :class:`repro_torch.core.interval_store.FlatIntervalState` these are live
    zero-copy views of the size-map columns) plus in-block first-toucher
    attribution.  Under phased block replay the block-start snapshot doubles
    as every phase's phase-start snapshot: mid-block evictions only consume
    keys whose last in-block occurrence precedes the phase boundary (the
    legal-victim invariant), so no key a later phase still serves can lose
    its snapshot presence mid-block and the one resolution stays exact for
    all phases.  The caller must already have cleared the origin row and
    each run's own-DTN entry.

    Returns ``(src, best_bw, accepted)`` under the reference's §IV-D rule:
    iterate candidate DTNs ascending keeping strict bandwidth improvements
    (max bandwidth, ties to the lowest DTN id), accept only where the
    winner strictly beats the run's origin link."""
    n = holders.shape[1]
    src = np.zeros(n, np.int64)
    best = np.zeros(n, np.float64)
    for d2 in range(1, holders.shape[0]):
        b2 = bw_col[d2]
        upd = holders[d2] & (b2 > best)
        if upd.any():
            src[upd] = d2
            best[upd] = b2[upd]
    accepted = best > bw_col[0]
    return src, best, accepted


def coalesce_peer_ranges(req_pos: np.ndarray, dtn: np.ndarray,
                         src: np.ndarray, key_lo: np.ndarray,
                         key_hi: np.ndarray) -> list[PeerFetchRange]:
    """Merge accepted per-run peer decisions into maximal
    :class:`PeerFetchRange` transfers (same request, same source, abutting
    key runs).  Runs must arrive grouped by request with keys ascending
    within each request — the fused block replay's natural emission order."""
    out: list[PeerFetchRange] = []
    for r, d, s, a, b in zip(req_pos.tolist(), dtn.tolist(), src.tolist(),
                             key_lo.tolist(), key_hi.tolist()):
        if out and out[-1].req_pos == r and out[-1].src == s \
                and out[-1].key_hi == a:
            out[-1] = out[-1]._replace(key_hi=b)
        else:
            out.append(PeerFetchRange(r, d, s, a, b))
    return out


def make_prefetcher(kind: str, grid: ObjectGrid,
                    training_requests: Sequence[Request] | None = None,
                    device=None):
    """Build a named prefetcher; ``device`` (CUDA by default) is where its
    ARIMA fits run."""
    device = resolve_device(device)
    kind = kind.lower()
    if kind in ("none", "cache_only", "no_cache"):
        return NoPrefetch()
    if kind == "hpm":
        return HPMAdapter(training_requests, device=device)
    if kind == "md1":
        return MD1Adapter(grid, training_requests)
    if kind == "md2":
        return MD2Adapter(grid, training_requests, device=device)
    raise ValueError(f"unknown prefetcher: {kind}")
