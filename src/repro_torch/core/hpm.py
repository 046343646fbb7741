"""Hybrid Pre-fetching Model (HPM) — the paper's §IV-A.

Routes each user's request stream to the appropriate predictor:

- **program users** (repetition detected ≥ REPEAT_THRESHOLD times within the
  LEARNING_PERIOD): *history-based* model — ARIMA over the user's request
  timestamps predicts ``ts_{i+1}``; data is pre-fetched at
  ``ts_i + offset · (ts_{i+1} − ts_i)`` (offset = 0.8) for the user's
  repeated object set, with the requested time-range advanced like a moving
  window.
- **real-time users** (period ≤ 120 s): handed to the *streaming* mechanism
  (see :mod:`repro_torch.core.streaming`) — subscribe once, push every new chunk.
- **human / unclassified**: *association-rule* model — FP-Growth rules
  (support=30, confidence=0.5) predict the next objects; only the top n=3 are
  pre-fetched; ``ts_{i+1} = ts_i + (ts_i − ts_{i−1})``, ``tr_{i+1} = tr_i``,
  issued at the same ``offset`` fraction of the predicted gap as the history
  model.

Two execution modes share one semantic definition:

- :class:`HybridPrefetcher` — the *online* model: observe requests one at a
  time, emit pre-fetch plans immediately.  This is what the reference
  simulator replays.
- :class:`BatchedHPMPlanner` — the *two-phase batch* planner used by the
  vectorized engine: phase one replays the same per-user classification
  state machine over the user-grouped request arrays (resolving every
  fast-path and rules prediction as it goes, memoizing repeated rule
  lookups), phase two flushes all deferred ARIMA work through the ARIMA
  bank (:meth:`repro_torch.core.arima.ARIMA.batched_forecast`) and materializes
  the remaining ops.  Because prediction depends only on the request
  stream — never on cache state — the planner emits exactly the op stream
  ``observe`` would, op for op (pinned by ``tests/test_torch_hpm.py``).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.arima import (ARIMA, _gap_stats, clamp_forecast_gap,
                              predict_next_timestamp)
from repro_torch.core.classify import REALTIME_PERIOD
from repro_torch.core.fpgrowth import RulePredictor
from repro_torch.core.trace import WEEK, Request

LEARNING_PERIOD = WEEK
REPEAT_THRESHOLD = 3
PREFETCH_OFFSET = 0.8
TOP_N_HUMAN = 3


@dataclasses.dataclass(frozen=True)
class PrefetchOp:
    """One planned pre-fetch: push (obj, [tr_start, tr_end]) toward user at
    time ``issue_ts``."""

    issue_ts: float
    user_id: int
    obj: int
    tr_start: float
    tr_end: float
    reason: str      # "history" | "rules" | "stream"


@dataclasses.dataclass
class _UserState:
    timestamps: list[float] = dataclasses.field(default_factory=list)
    objs: collections.Counter = dataclasses.field(
        default_factory=collections.Counter
    )
    recent_objs: list[int] = dataclasses.field(default_factory=list)
    last_window: float = 0.0
    first_ts: float = 0.0
    pattern_repeats: int = 0
    classified: str = "unknown"     # unknown | program | realtime | human
    last_cycle_objs: frozenset = frozenset()
    cycle_objs: set = dataclasses.field(default_factory=set)
    cycle_start: float = 0.0


def _observe_classification(st: _UserState, r: Request) -> None:
    """Online classification (paper §IV-A2) — one request into the user's
    state machine.  Shared verbatim by the online model and the batch
    planner so their classification decisions cannot diverge."""
    if not st.timestamps:
        st.first_ts = r.ts
        st.cycle_start = r.ts
    st.timestamps.append(r.ts)
    if len(st.timestamps) > 200:
        del st.timestamps[:100]
    st.objs[r.obj] += 1
    st.recent_objs.append(r.obj)
    if len(st.recent_objs) > 16:
        del st.recent_objs[0]
    st.last_window = r.tr_end - r.tr_start

    if st.classified in ("program", "realtime"):
        return
    # repetition detection: did the user re-request the same object set?
    st.cycle_objs.add(r.obj)
    if st.last_cycle_objs and r.obj in st.last_cycle_objs and \
            st.cycle_objs >= st.last_cycle_objs:
        st.pattern_repeats += 1
        st.last_cycle_objs = frozenset(st.cycle_objs)
        st.cycle_objs = set()
    elif not st.last_cycle_objs and len(st.timestamps) >= 2 and \
            r.obj in st.cycle_objs and len(st.cycle_objs) >= 1:
        st.last_cycle_objs = frozenset(st.cycle_objs)
        st.cycle_objs = set()
    if st.pattern_repeats >= REPEAT_THRESHOLD and \
            (r.ts - st.first_ts) <= LEARNING_PERIOD * 2:
        gaps = np.diff(np.array(sorted(set(st.timestamps))[-12:]))
        period = float(np.median(gaps)) if gaps.size else float("inf")
        st.classified = "realtime" if period <= REALTIME_PERIOD else "program"
    elif (r.ts - st.first_ts) > LEARNING_PERIOD and st.pattern_repeats == 0:
        st.classified = "human"


def _history_ops(now: float, user_id: int, offset: float, width: float,
                 objs, next_ts: float) -> list[PrefetchOp]:
    """Materialize history-model ops: pre-fetch the user's whole repeated
    object set at the offset point of the predicted gap, window advanced."""
    issue = now + offset * max(0.0, next_ts - now)
    return [
        PrefetchOp(issue, user_id, int(obj), next_ts - width, next_ts,
                   "history")
        for obj in sorted(objs)
    ]


def _stream_op(r: Request, st: _UserState) -> PrefetchOp:
    """Materialize the one-time hand-off of a real-time user to the
    streaming mechanism: subscribe from the requested range's end, with the
    user's window as the initial publication period."""
    return PrefetchOp(r.ts, r.user_id, r.obj, r.tr_end,
                      r.tr_end + st.last_window, "stream")


def _rules_ops(r: Request, offset: float, next_ts: float,
               preds) -> list[PrefetchOp]:
    """Materialize association-rule ops (paper §IV-A3): the top predicted
    objects with ``tr_{i+1} = tr_i`` (identical range to the last request),
    issued at the offset point of the predicted gap — same issue convention
    as the history model."""
    issue = r.ts + offset * max(0.0, next_ts - r.ts)
    return [
        PrefetchOp(issue, r.user_id, int(obj), r.tr_start, r.tr_end, "rules")
        for obj in preds
    ]


class HybridPrefetcher:
    """Online HPM: observe requests one at a time, emit pre-fetch plans."""

    def __init__(
        self,
        rule_transactions: Sequence[Sequence[int]] | None = None,
        min_support: int = 30,
        min_confidence: float = 0.5,
        offset: float = PREFETCH_OFFSET,
        arima_history: int = 60,
        device=None,
    ):
        self.offset = offset
        self.arima = ARIMA(n=arima_history, device=device)
        self.users: dict[int, _UserState] = collections.defaultdict(_UserState)
        self.rule_predictor = (
            RulePredictor(rule_transactions, min_support, min_confidence)
            if rule_transactions
            else None
        )
        self.realtime_subscriptions: set[tuple[int, int]] = set()  # (user, obj)

    # -- prediction ----------------------------------------------------------

    def observe(self, r: Request) -> list[PrefetchOp]:
        """Feed one request; return pre-fetch ops to schedule now."""
        st = self.users[r.user_id]
        _observe_classification(st, r)
        if st.classified == "realtime":
            key = (r.user_id, r.obj)
            if key not in self.realtime_subscriptions:
                self.realtime_subscriptions.add(key)
                # streaming engine takes over; no per-request prefetch needed
                return [_stream_op(r, st)]
            return []
        if st.classified == "program":
            return self._predict_history(st, r)
        if st.classified == "human":
            return self._predict_rules(st, r)
        return []   # still learning

    def _predict_history(self, st: _UserState, r: Request) -> list[PrefetchOp]:
        ts_hist = np.array(sorted(set(st.timestamps)))
        if ts_hist.size < 4:
            return []
        next_ts = predict_next_timestamp(ts_hist, self.arima)
        return _history_ops(r.ts, r.user_id, self.offset, st.last_window,
                            st.last_cycle_objs or {r.obj}, next_ts)

    def _predict_rules(self, st: _UserState, r: Request) -> list[PrefetchOp]:
        if self.rule_predictor is None:
            return []
        preds = self.rule_predictor.predict(st.recent_objs, top_n=TOP_N_HUMAN)
        if not preds:
            return []
        ts = st.timestamps
        # paper §IV-A: ts_{i+1} = ts_i + (ts_i − ts_{i−1})
        gap = (ts[-1] - ts[-2]) if len(ts) >= 2 else 300.0
        return _rules_ops(r, self.offset, r.ts + gap, preds)

    # convenience ------------------------------------------------------------

    def classification(self, user_id: int) -> str:
        return self.users[user_id].classified if user_id in self.users else "unknown"


_NO_OPS: tuple = ()
_MEMO_MISS = object()
# rule-prediction memo bound: predictions are pure in the recent-object
# frozenset, so clearing the cache never changes results — it only re-runs
# lookups.  Bounds planner memory on human-heavy full-scale traces.
_RULE_MEMO_MAX = 200_000


class BatchedHPMPlanner:
    """Two-phase batch planner: the whole-trace equivalent of the online
    ``observe`` loop.

    HPM prediction is a pure function of the request stream (cache state
    never feeds back into it), so the full per-request op stream can be
    planned ahead of replay:

    - **phase 1 — classification & fast paths**: requests are grouped by
      user and each user's sequence is replayed through the shared
      classification state machine.  A sorted-unique timestamp array and its
      gap series are maintained *incrementally* (the online path re-sorts
      per request), near-constant-gap predictions resolve immediately via
      the shared :func:`repro_torch.core.arima._gap_stats`, rule predictions are
      memoized on the (frozen) recent-object set, and noisy-gap histories
      are deferred as ARIMA tasks.
    - **phase 2 — bank flush**: all deferred gap series go through
      :meth:`ARIMA.batched_forecast` — one ARIMA bank kernel launch per
      history bucket — and the resulting ops are written back to their
      request slots.

    The emitted stream is bitwise identical to calling ``observe`` per
    request (fixed-width ARIMA bank + shared helpers; pinned by
    ``tests/test_torch_hpm.py``).

    **Window mode**: the planner keeps all per-user classification state
    (and the rule memo / subscription set) on the instance, so a trace may
    be fed in arbitrary timestamp-ordered windows via repeated
    :meth:`plan_window` calls.  Prediction is a pure per-user function of
    that user's request subsequence — cache state never feeds back — and
    the ARIMA bank's rows are batch-composition independent (pinned by
    ``test_bank_rows_independent_of_batch_composition``), so *any* window
    split (width 1 → whole trace) emits the identical op stream; one
    :meth:`plan` call on a fresh instance is just the single-window case.
    Phase-2 bank flushes happen once per window, bounding peak plan
    storage by the window size instead of the trace length.
    """

    def __init__(self, model: HybridPrefetcher):
        self.model = model
        # per-user (st, uniq, gaps): uniq == sorted(set(st.timestamps)),
        # gaps == np.diff(uniq) — maintained incrementally across windows
        self._users: dict[int, tuple[_UserState, list[float], list[float]]] = {}
        self._rule_memo: dict[frozenset, list] = {}
        self._subscribed: set[tuple[int, int]] = set()

    def plan(self, requests: Sequence[Request]) -> list[Sequence[PrefetchOp]]:
        """Per-request op lists (``"stream"`` ops included) equal to what
        ``observe`` would emit, without mutating the online model."""
        return self.plan_window(requests)

    def plan_window(self, requests: Sequence[Request]
                    ) -> list[Sequence[PrefetchOp]]:
        """Plan one timestamp-ordered window of the trace, carrying the
        per-user classification state forward to the next call."""
        model = self.model
        offset = model.offset
        rp = model.rule_predictor
        out: list[Sequence[PrefetchOp]] = [_NO_OPS] * len(requests)

        by_user: dict[int, list[int]] = {}
        for i, r in enumerate(requests):
            by_user.setdefault(r.user_id, []).append(i)

        # (slot, gaps_f32, last_ts, max_gap, req_ts, width, objs)
        pending: list[tuple] = []
        rule_memo = self._rule_memo
        subscribed = self._subscribed

        for uid, idxs in by_user.items():
            cached = self._users.get(uid)
            if cached is None:
                st = _UserState()
                uniq: list[float] = []
                gaps: list[float] = []
                self._users[uid] = (st, uniq, gaps)
            else:
                st, uniq, gaps = cached
            for i in idxs:
                r = requests[i]
                prev_len = len(st.timestamps)
                _observe_classification(st, r)
                if len(st.timestamps) != prev_len + 1:
                    # history trim: rebuild the unique view
                    uniq = sorted(set(st.timestamps))
                    gaps = [b - a for a, b in zip(uniq, uniq[1:])]
                elif not uniq or r.ts > uniq[-1]:
                    if uniq:
                        gaps.append(r.ts - uniq[-1])
                    uniq.append(r.ts)
                elif r.ts < uniq[-1]:
                    # out-of-order arrival (traces are sorted; kept correct
                    # for arbitrary input)
                    j = bisect.bisect_left(uniq, r.ts)
                    if j >= len(uniq) or uniq[j] != r.ts:
                        uniq.insert(j, r.ts)
                        gaps = [b - a for a, b in zip(uniq, uniq[1:])]
                # else: duplicate of the latest timestamp — no change

                cls = st.classified
                if cls == "realtime":
                    key = (uid, r.obj)
                    if key not in subscribed:
                        subscribed.add(key)
                        out[i] = [_stream_op(r, st)]
                elif cls == "program":
                    if len(uniq) < 4:
                        continue
                    med, max_gap, fast = _gap_stats(gaps)
                    objs = st.last_cycle_objs or {r.obj}
                    if fast:
                        out[i] = _history_ops(r.ts, uid, offset,
                                              st.last_window, objs,
                                              uniq[-1] + med)
                    else:
                        pending.append(
                            (i, np.asarray(gaps, np.float32), uniq[-1],
                             max_gap, r.ts, st.last_window, objs))
                elif cls == "human" and rp is not None:
                    key = frozenset(st.recent_objs)
                    preds = rule_memo.get(key, _MEMO_MISS)
                    if preds is _MEMO_MISS:
                        if len(rule_memo) >= _RULE_MEMO_MAX:
                            rule_memo.clear()
                        preds = rule_memo[key] = rp.predict(
                            st.recent_objs, top_n=TOP_N_HUMAN)
                    if preds:
                        ts_l = st.timestamps
                        gap = (ts_l[-1] - ts_l[-2]) if len(ts_l) >= 2 else 300.0
                        out[i] = _rules_ops(r, offset, r.ts + gap, preds)
            # uniq/gaps are rebound on trim/out-of-order branches: store the
            # current bindings for the next window
            self._users[uid] = (st, uniq, gaps)

        if pending:
            forecasts = model.arima.batched_forecast([t[1] for t in pending])
            for (i, _, last, max_gap, r_ts, width, objs), g in zip(
                    pending, forecasts):
                next_ts = clamp_forecast_gap(last, float(g), max_gap)
                out[i] = _history_ops(r_ts, requests[i].user_id, offset,
                                      width, objs, next_ts)
        return out


def build_rule_transactions(
    requests: Iterable[Request], session_seconds: float = 3600.0
) -> list[list[int]]:
    """Sessionize a training trace into transactions for FP-Growth: the
    objects a user co-accesses within one session window."""
    sessions: dict[tuple[int, int], list[int]] = collections.defaultdict(list)
    for r in requests:
        sessions[(r.user_id, int(r.ts // session_seconds))].append(r.obj)
    return [list(dict.fromkeys(v)) for v in sessions.values()]
