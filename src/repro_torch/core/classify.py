"""User and request classification (paper §III-B..E).

Implements the paper's classification method:

- **Human vs program users** (§III-B): maintain a running time window (one
  week); a user that requests the same set of data objects more than once a
  day, with the pattern repeating every day of the window, is a *program
  user*; everything else is a *human user*.

- **Program request types** (§III-D): *regular* (fresh moving window),
  *real-time* (regular with period ≤ REALTIME_PERIOD), *overlapping*
  (consecutive time-ranges overlap).

- **Fresh vs duplicate bytes** (§III-E): interval-coverage analysis of each
  user's requested ranges per object.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.trace import DAY, WEEK, Request

REALTIME_PERIOD = 120.0      # seconds; <= this inter-arrival => real-time
OVERLAP_EPS = 1.0            # seconds of tolerated boundary slack


@dataclasses.dataclass
class UserStats:
    user_id: int
    kind: str                    # "human" | "program"
    n_requests: int
    bytes: int
    request_type: str | None     # program only: regular|realtime|overlapping
    period: float | None         # program only: median inter-arrival
    fresh_bytes: int = 0
    duplicate_bytes: int = 0


def group_by_user(requests: Iterable[Request]) -> dict[int, list[Request]]:
    by_user: dict[int, list[Request]] = collections.defaultdict(list)
    for r in requests:
        by_user[r.user_id].append(r)
    for reqs in by_user.values():
        reqs.sort(key=lambda r: r.ts)
    return dict(by_user)


def _is_program_user(reqs: Sequence[Request], window: float = WEEK) -> bool:
    """Paper rule: same set of objects requested >1/day, repeating daily,
    within the running window (we evaluate the densest window of the trace)."""
    if len(reqs) < 4:
        return False
    ts = np.array([r.ts for r in reqs])
    span = ts[-1] - ts[0]
    horizon = min(window, max(span, 1.0))
    n_days = max(1, int(horizon // DAY))
    if n_days < 2:
        # short traces: fall back to periodicity of inter-arrivals
        return _is_periodic(reqs)
    # objects requested per day within the first `window` of activity
    start = ts[0]
    daily_sets: list[frozenset[int]] = []
    daily_counts: list[collections.Counter] = []
    for d in range(n_days):
        lo, hi = start + d * DAY, start + (d + 1) * DAY
        day_reqs = [r for r in reqs if lo <= r.ts < hi]
        daily_sets.append(frozenset(r.obj for r in day_reqs))
        daily_counts.append(collections.Counter(r.obj for r in day_reqs))
    base = daily_sets[0]
    if not base:
        return False
    for s, c in zip(daily_sets, daily_counts):
        if s != base:
            return False
        if min(c.values(), default=0) < 1:
            return False
    # ">1 per day" for at least the base set on a typical day
    typical = daily_counts[n_days // 2]
    return all(typical[o] >= 1 for o in base) and sum(typical.values()) >= len(base)


def _is_periodic(reqs: Sequence[Request], tol: float = 0.15) -> bool:
    ts = np.array(sorted({r.ts for r in reqs}))
    if len(ts) < 4:
        return False
    gaps = np.diff(ts)
    med = np.median(gaps)
    if med <= 0:
        return False
    return bool(np.mean(np.abs(gaps - med) <= tol * med) > 0.7)


def classify_users(
    requests: Iterable[Request], window: float = WEEK
) -> dict[int, str]:
    """Return {user_id: "human"|"program"} per the paper's rule."""
    out: dict[int, str] = {}
    for uid, reqs in group_by_user(requests).items():
        out[uid] = "program" if _is_program_user(reqs, window) else "human"
    return out


# ---------------------------------------------------------------------------
# Program request-type classification (§III-D)
# ---------------------------------------------------------------------------

def classify_request_type(reqs: Sequence[Request]) -> tuple[str, float]:
    """Classify one program user's per-object request stream.

    Returns (type, median_period) with type in regular|realtime|overlapping.
    """
    ts = np.array(sorted({r.ts for r in reqs}))
    period = float(np.median(np.diff(ts))) if len(ts) >= 2 else float("inf")
    # overlap check on consecutive requests of the same object
    by_obj: dict[int, list[Request]] = collections.defaultdict(list)
    for r in reqs:
        by_obj[r.obj].append(r)
    overlap_votes, total_votes = 0, 0
    for obj_reqs in by_obj.values():
        obj_reqs.sort(key=lambda r: r.ts)
        for a, b in zip(obj_reqs, obj_reqs[1:]):
            total_votes += 1
            if b.tr_start < a.tr_end - OVERLAP_EPS:
                overlap_votes += 1
    if total_votes and overlap_votes / total_votes > 0.5:
        return "overlapping", period
    if period <= REALTIME_PERIOD:
        return "realtime", period
    return "regular", period


# ---------------------------------------------------------------------------
# Fresh / duplicate byte accounting (§III-E)
# ---------------------------------------------------------------------------

def fresh_duplicate_bytes(reqs: Sequence[Request]) -> tuple[int, int]:
    """Split one user's transferred bytes into fresh vs duplicate via interval
    coverage per object (duplicate = portion of the range already requested)."""
    covered: dict[int, list[tuple[float, float]]] = collections.defaultdict(list)
    fresh = dup = 0
    for r in sorted(reqs, key=lambda r: r.ts):
        ivs = covered[r.obj]
        lo, hi = r.tr_start, r.tr_end
        length = max(0.0, hi - lo)
        if length == 0:
            continue
        overlap = 0.0
        for s, e in ivs:
            overlap += max(0.0, min(hi, e) - max(lo, s))
        overlap = min(overlap, length)
        frac_dup = overlap / length
        fresh += int(r.size_bytes * (1 - frac_dup))
        dup += int(r.size_bytes * frac_dup)
        ivs.append((lo, hi))
        # merge intervals to keep the list small
        ivs.sort()
        merged = [ivs[0]]
        for s, e in ivs[1:]:
            if s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        covered[r.obj] = merged
    return fresh, dup


# ---------------------------------------------------------------------------
# Full-trace summary (reproduces Tables I & II)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TraceSummary:
    n_users: int
    human_user_frac: float
    program_user_frac: float
    human_volume_frac: float
    program_volume_frac: float
    type_volume_frac: Mapping[str, float]      # over program volume
    overlap_fresh_frac: float
    overlap_duplicate_frac: float
    user_stats: list[UserStats]


def summarize_trace(requests: Sequence[Request]) -> TraceSummary:
    by_user = group_by_user(requests)
    kinds = classify_users(requests)
    stats: list[UserStats] = []
    vol = {"human": 0, "program": 0}
    type_vol: collections.Counter = collections.Counter()
    ofresh = odup = 0
    for uid, reqs in by_user.items():
        b = sum(r.size_bytes for r in reqs)
        kind = kinds[uid]
        vol[kind] += b
        rtype = period = None
        if kind == "program":
            rtype, period = classify_request_type(reqs)
            type_vol[rtype] += b
            if rtype == "overlapping":
                f, d = fresh_duplicate_bytes(reqs)
                ofresh += f
                odup += d
        stats.append(UserStats(uid, kind, len(reqs), b, rtype, period))
    total = max(1, vol["human"] + vol["program"])
    pvol = max(1, sum(type_vol.values()))
    ovl = max(1, ofresh + odup)
    n_users = len(by_user)
    n_prog = sum(1 for k in kinds.values() if k == "program")
    return TraceSummary(
        n_users=n_users,
        human_user_frac=(n_users - n_prog) / max(1, n_users),
        program_user_frac=n_prog / max(1, n_users),
        human_volume_frac=vol["human"] / total,
        program_volume_frac=vol["program"] / total,
        type_volume_frac={k: v / pvol for k, v in type_vol.items()},
        overlap_fresh_frac=ofresh / ovl,
        overlap_duplicate_frac=odup / ovl,
        user_stats=stats,
    )
