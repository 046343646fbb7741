"""Request/trace data model and calibrated synthetic OOI/GAGE trace generators.

The paper analyses two access traces (OOI: 17.9M requests / Nov 2018; GAGE:
77.8M requests / 2018).  Those traces are not redistributable, so this module
generates synthetic traces *calibrated to every statistic the paper publishes*:

- Table I   : human/program user split and data-volume split,
- Table II  : regular/real-time/overlapping volume mix and the fresh/duplicate
              breakdown of overlapping transfers,
- Fig 2     : per-continent user distribution (GAGE),
- Fig 3     : the moving-window temporal shape of program requests,
- Fig 4     : spatial-temporal correlation of human requests.

``tests/test_trace_calibration.py`` verifies that the classification pipeline
in :mod:`repro_torch.core.classify` recovers the Table I/II statistics from these
generators — that is the reproduction of §III of the paper.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from itertools import zip_longest
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np


def itertools_zip_longest(groups):
    return zip_longest(*groups)

# ---------------------------------------------------------------------------
# Data model
# ---------------------------------------------------------------------------

HOUR = 3600.0
DAY = 24 * HOUR
WEEK = 7 * DAY
MINUTE = 60.0


@dataclasses.dataclass(frozen=True, slots=True)
class Request:
    """One entry of an observatory access log (paper §III, Eq. 1).

    A request tuple ``r_i = (ts, d, tr)``: access timestamp, data-object name
    and requested observation time-range.  ``size_bytes`` is derived from the
    time range and per-stream data rate.  ``continent`` is the coarse client
    location recovered from the public IP (paper Fig 2).
    """

    ts: float                 # access timestamp (s since trace start)
    user_id: int
    obj: int                  # serialized data-object id (instrument, location)
    tr_start: float           # requested range start (observation time, s)
    tr_end: float             # requested range end
    size_bytes: int
    continent: int            # 0..5 (six continents, Antarctica excluded)

    @property
    def tr(self) -> float:
        return self.tr_end - self.tr_start


@dataclasses.dataclass(frozen=True, slots=True)
class ObjectGrid:
    """Instrument catalog: ``n_types`` instrument types × ``n_locs`` locations.

    Object ids are serialized as ``type * n_locs + loc`` mirroring Fig 4 where
    rows are instrument ids and columns are proximity-sorted locations.
    """

    n_types: int
    n_locs: int

    @property
    def n_objects(self) -> int:
        return self.n_types * self.n_locs

    def obj_id(self, itype: int, loc: int) -> int:
        return itype * self.n_locs + loc

    def type_of(self, obj: int) -> int:
        return obj // self.n_locs

    def loc_of(self, obj: int) -> int:
        return obj % self.n_locs


@dataclasses.dataclass(frozen=True)
class TraceProfile:
    """Calibration constants for one observatory (Tables I & II + Fig 2)."""

    name: str
    n_users: int
    duration: float                       # trace length in seconds
    human_user_frac: float                # Table I (users)
    program_volume_frac: float            # Table I (volume)
    # Volume mix across program request types (Table II): regular, real-time,
    # overlapping.  Must sum to 1 (these are fractions of *program* volume —
    # the paper reports fractions of total volume; program volume dominates).
    type_volume_mix: tuple[float, float, float]
    overlap_duplicate_frac: float         # Table II right half
    continent_probs: tuple[float, ...]    # Fig 2 user distribution
    bytes_per_second_stream: float        # data rate of one stream
    grid: ObjectGrid
    # Scheduling noise of program users as a fraction of their period.  The
    # default 1% keeps inter-arrival gaps inside the HPM predictor's
    # near-constant-median fast path; raising it past ~2% forces real ARIMA
    # fits per prediction (the regime the ARIMA bank kernel accelerates —
    # see the hpm scenarios in benchmarks/bench_engine.py).
    period_jitter_frac: float = 0.01


# Continent order: N.America, Asia, Europe, S.America, Africa, Oceania.
# GAGE user distribution approximated from Fig 2; OOI is more US-centric.
GAGE_PROFILE = TraceProfile(
    name="gage",
    n_users=600,
    duration=8 * WEEK,
    human_user_frac=0.941,
    program_volume_frac=0.906,
    type_volume_mix=(0.772, 0.061, 0.172),
    overlap_duplicate_frac=0.896,
    continent_probs=(0.28, 0.37, 0.18, 0.07, 0.04, 0.06),
    bytes_per_second_stream=2e3,
    grid=ObjectGrid(n_types=24, n_locs=40),
)

OOI_PROFILE = TraceProfile(
    name="ooi",
    n_users=400,
    duration=4 * WEEK,
    human_user_frac=0.867,
    program_volume_frac=0.901,
    type_volume_mix=(0.138, 0.257, 0.608),
    overlap_duplicate_frac=0.904,
    continent_probs=(0.62, 0.12, 0.14, 0.05, 0.02, 0.05),
    bytes_per_second_stream=8e3,
    grid=ObjectGrid(n_types=30, n_locs=30),
)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

def _normalize(v: Sequence[float]) -> np.ndarray:
    a = np.asarray(v, dtype=np.float64)
    return a / a.sum()


def _zipf_probs(n: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


def _plan_program_users(profile: TraceProfile, rng: np.random.Generator,
                        n_program: int) -> list[dict]:
    """Assign each program user a behaviour.  User counts follow the volume
    mix (more users where more volume).  Shared by :class:`TraceGenerator`
    (which applies exact post-hoc volume calibration on top) and
    :class:`StreamingTraceSynthesizer` (which streams, so it cannot)."""
    p = profile
    mix = _normalize(p.type_volume_mix)
    dup = p.overlap_duplicate_frac
    k_overlap = max(2, int(round(1.0 / max(1e-6, 1.0 - dup))))
    n_by_type = np.maximum(1, np.round(mix * n_program)).astype(int)
    per_type: list[list[dict]] = [[], [], []]
    for btype, n in enumerate(n_by_type):
        for _ in range(int(n)):
            if btype == 0:      # regular
                period = float(rng.choice([HOUR, 2 * HOUR, 6 * HOUR]))
                window = period
            elif btype == 1:    # real-time
                period = MINUTE
                window = MINUTE
            else:               # overlapping
                period = HOUR
                window = k_overlap * HOUR
            per_type[btype].append(
                dict(
                    behaviour=("regular", "realtime", "overlapping")[btype],
                    period=period,
                    window=window,
                    n_streams=int(rng.integers(1, 4)),
                )
            )
    # round-robin across types so truncation keeps type diversity
    plans: list[dict] = []
    for group in itertools_zip_longest(per_type):
        plans.extend(p for p in group if p is not None)
    return plans[:n_program] if len(plans) > n_program else plans


class TraceGenerator:
    """Synthesize an access trace calibrated to a :class:`TraceProfile`.

    Program users are split into three behaviours (paper Fig 3):

    - *regular*:     period P, window == P (fresh moving window),
    - *real-time*:   period 60 s, window == 60 s (high-frequency regular),
    - *overlapping*: period P, window k·P with k≈24 (e.g. past-day every hour).

    Human users run short browsing sessions with spatial-temporal correlation:
    a session picks a region and walks nearby (type, loc) cells (Fig 4).
    """

    def __init__(self, profile: TraceProfile, seed: int = 0):
        self.profile = profile
        self.rng = np.random.default_rng(seed)

    # -- program users ------------------------------------------------------

    def _program_user_plan(self, n_program: int) -> list[dict]:
        return _plan_program_users(self.profile, self.rng, n_program)

    def _gen_program_requests(
        self, user_id: int, plan: dict, continent: int
    ) -> list[Request]:
        p = self.profile
        period, window = plan["period"], plan["window"]
        # Real-time users would emit 60k+ requests over months; subsample the
        # active span to keep synthetic traces tractable while preserving the
        # high-frequency *pattern* (the classifier sees period=60s regardless).
        if plan["behaviour"] == "realtime":
            span = min(p.duration, 3 * DAY)
        else:
            span = p.duration
        start = float(self.rng.uniform(0, period))
        # stream choice follows object popularity (Zipf) — popular
        # instruments are polled by many programs worldwide, which is what
        # makes peer DTN caches and hub placement effective (paper §IV-C)
        objs = self.rng.choice(p.grid.n_objects, size=plan["n_streams"],
                               replace=False,
                               p=_zipf_probs(p.grid.n_objects, alpha=1.0))
        out: list[Request] = []
        t = start
        overlapping = plan["behaviour"] == "overlapping"
        last_end: dict[int, float] = {}
        while t < span:
            # small jitter mirrors real script scheduling noise
            jitter = float(self.rng.normal(0.0, p.period_jitter_frac * period))
            ts = max(0.0, t + jitter)
            for obj in objs:
                tr_end = ts
                if overlapping:
                    # past-window every period (e.g. past day every hour)
                    tr_start = max(0.0, ts - window)
                else:
                    # "new data since the last request, without any overlap"
                    tr_start = last_end.get(int(obj), max(0.0, ts - window))
                    last_end[int(obj)] = tr_end
                size = int((tr_end - tr_start) * p.bytes_per_second_stream)
                out.append(
                    Request(ts, user_id, int(obj), tr_start, tr_end, size, continent)
                )
            t += period
        return out

    # -- human users --------------------------------------------------------

    def _gen_human_requests(self, user_id: int, continent: int) -> list[Request]:
        p = self.profile
        g = p.grid
        n_sessions = int(self.rng.integers(1, 4))
        out: list[Request] = []
        type_pop = _zipf_probs(g.n_types)
        for _ in range(n_sessions):
            t0 = float(self.rng.uniform(0, p.duration))
            # Session anchor region (Fig 4: users browse one region)
            loc = int(self.rng.integers(0, g.n_locs))
            itype = int(self.rng.choice(g.n_types, p=type_pop))
            n_req = int(self.rng.integers(3, 12))
            t = t0
            for _ in range(n_req):
                # random walk: same loc different type (column) or same type
                # nearby loc (row) — the two correlations visible in Fig 4.
                if self.rng.random() < 0.5:
                    itype = int(self.rng.choice(g.n_types, p=type_pop))
                else:
                    loc = int(np.clip(loc + self.rng.integers(-2, 3), 0, g.n_locs - 1))
                obj = g.obj_id(itype, loc)
                window = float(self.rng.choice([HOUR, 6 * HOUR, DAY]))
                tr_end = float(self.rng.uniform(0, max(1.0, t - 1.0))) if t > 2 else t
                tr_start = max(0.0, tr_end - window)
                size = int((tr_end - tr_start) * p.bytes_per_second_stream * 0.1)
                out.append(Request(t, user_id, obj, tr_start, tr_end, size, continent))
                t += float(self.rng.exponential(120.0))
        return out

    # -- public API ---------------------------------------------------------

    def generate(self) -> "RequestList":
        p = self.profile
        n_human = int(round(p.n_users * p.human_user_frac))
        n_program = p.n_users - n_human
        cont_p = _normalize(p.continent_probs)
        plans = self._program_user_plan(n_program)
        uid = 0
        by_type: dict[str, list[Request]] = {
            "regular": [], "realtime": [], "overlapping": []}
        for plan in plans:
            cont = int(self.rng.choice(6, p=cont_p))
            by_type[plan["behaviour"]].extend(
                self._gen_program_requests(uid, plan, cont))
            uid += 1
        human: list[Request] = []
        for _ in range(n_human):
            cont = int(self.rng.choice(6, p=cont_p))
            human.extend(self._gen_human_requests(uid, cont))
            uid += 1

        # --- exact volume calibration (Tables I & II) -----------------------
        # Per-type stream-rate multipliers so program volume mix matches
        # type_volume_mix exactly; human sizes scaled so the human/program
        # volume split matches Table I.
        mix = _normalize(p.type_volume_mix)
        order = ("regular", "realtime", "overlapping")
        totals = np.array(
            [max(1, sum(r.size_bytes for r in by_type[t])) for t in order],
            dtype=np.float64,
        )
        # target proportional volumes, anchored on the regular type
        target = mix / mix[0] * totals[0]
        mult = target / totals
        program: list[Request] = []
        for t, m in zip(order, mult):
            for r in by_type[t]:
                program.append(
                    dataclasses.replace(r, size_bytes=max(1, int(r.size_bytes * m)))
                )
        prog_total = sum(r.size_bytes for r in program)
        hum_total = max(1, sum(r.size_bytes for r in human))
        h_frac = 1.0 - p.program_volume_frac
        h_factor = (prog_total * h_frac / max(1e-9, p.program_volume_frac)) / hum_total
        human = [
            dataclasses.replace(r, size_bytes=max(1, int(r.size_bytes * h_factor)))
            for r in human
        ]
        requests = RequestList(program + human)
        requests.sort(key=lambda r: r.ts)
        return requests


def total_bytes(requests: Iterable[Request]) -> int:
    return sum(r.size_bytes for r in requests)


@dataclasses.dataclass(frozen=True)
class RequestArrays:
    """Structure-of-arrays view of a trace (one column per Request field).

    The vectorized replay engine consumes traces in this form: chunk ranges,
    per-chunk sizes and DTN assignment are then computable for the *whole*
    trace with a handful of NumPy ops instead of per-request Python.
    """

    ts: np.ndarray            # float64 [n]
    user_id: np.ndarray       # int64   [n]
    obj: np.ndarray           # int64   [n]
    tr_start: np.ndarray      # float64 [n]
    tr_end: np.ndarray        # float64 [n]
    size_bytes: np.ndarray    # int64   [n]
    continent: np.ndarray     # int64   [n]

    def __len__(self) -> int:
        return int(self.ts.shape[0])


class RequestList(list):
    """A trace: a list of :class:`Request` that memoizes its
    :class:`RequestArrays` view.

    Replay engines and benchmarks convert the same trace to column arrays on
    every ``run_strategy`` call; for a full-scale trace that transpose costs
    more than a whole vectorized replay.  Every mutating list operation
    invalidates the memoized arrays, so in-place edits (sort, item
    replacement, appends, ...) can never serve a stale transpose; slicing
    returns a fresh :class:`RequestList`.
    """

    _arrays: "RequestArrays | None"

    def __init__(self, *args):
        super().__init__(*args)
        self._arrays = None

    def __getitem__(self, i):
        out = super().__getitem__(i)
        if not isinstance(i, slice):
            return out
        out = RequestList(out)
        cached = self._arrays
        if cached is not None and i.step in (None, 1):
            # contiguous slice of a memoized trace: the transpose slices
            # column-wise for free instead of being recomputed downstream
            start, stop, _ = i.indices(len(self))
            out._arrays = RequestArrays(
                *(getattr(cached, f.name)[start:stop]
                  for f in dataclasses.fields(RequestArrays)))
        return out


def _invalidating(name):
    base = getattr(list, name)

    def op(self, *args, **kw):
        self._arrays = None
        return base(self, *args, **kw)

    op.__name__ = name
    return op


for _name in ("__setitem__", "__delitem__", "__iadd__", "__imul__",
              "append", "extend", "insert", "pop", "remove", "sort",
              "reverse", "clear"):
    setattr(RequestList, _name, _invalidating(_name))


def requests_to_arrays(requests: Sequence[Request]) -> RequestArrays:
    """Transpose a trace into :class:`RequestArrays`.

    When ``requests`` is a :class:`RequestList` (what the generators return)
    the transpose is computed once and memoized on the list.
    """
    cached = getattr(requests, "_arrays", None)
    if cached is not None and len(cached) == len(requests):
        return cached
    arrays = _requests_to_arrays(requests)
    if isinstance(requests, RequestList):
        requests._arrays = arrays
    return arrays


def _requests_to_arrays(requests: Sequence[Request]) -> RequestArrays:
    return RequestArrays(
        np.array([r.ts for r in requests], np.float64),
        np.array([r.user_id for r in requests], np.int64),
        np.array([r.obj for r in requests], np.int64),
        np.array([r.tr_start for r in requests], np.float64),
        np.array([r.tr_end for r in requests], np.float64),
        np.array([r.size_bytes for r in requests], np.int64),
        np.array([r.continent for r in requests], np.int64),
    )


def make_trace(name: str, seed: int = 0, scale: float = 1.0) -> RequestList:
    """Convenience: generate the named observatory trace.

    ``scale`` scales user count (for fast tests use scale<1).
    """
    base = {"ooi": OOI_PROFILE, "gage": GAGE_PROFILE}[name]
    if scale != 1.0:
        base = dataclasses.replace(base, n_users=max(8, int(base.n_users * scale)))
    return TraceGenerator(base, seed=seed).generate()


# ---------------------------------------------------------------------------
# Streaming trace path (paper-scale replay: 17.9M-77.8M requests)
# ---------------------------------------------------------------------------


class StreamingRequestSource:
    """A restartable, windowed view of a request stream.

    The replay engines accept this in place of a materialized
    :class:`RequestList`: :meth:`windows` yields fixed-size
    ``RequestList`` windows in timestamp order, re-creating the
    underlying iterator from ``factory`` on every pass, so the full
    trace is never held in memory and the same source can drive several
    engine runs (equivalence audits included).

    ``tr_bounds`` is an optional ``(tr_lo, tr_hi)`` bound on every
    request's observation time-range.  The interval engine uses it to
    fix its dense chunk-key address space up front (the key labels are a
    pure renaming, so results are invariant to the exact bound — see
    ``docs/ARCHITECTURE.md``); without it, streaming falls back to the
    vector block replay's growable address space.
    """

    def __init__(self, factory: "Callable[[], Iterator[Request]]",
                 window: int = 65536, n_requests: int | None = None,
                 tr_bounds: tuple[float, float] | None = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._factory = factory
        self.window = int(window)
        self.n_requests = n_requests
        self.tr_bounds = tr_bounds

    def __iter__(self) -> Iterator[Request]:
        return self._factory()

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        if self.n_requests is None:
            raise TypeError("length of this streaming source is unknown")
        return self.n_requests

    def windows(self) -> "Iterator[RequestList]":
        it = self._factory()
        while True:
            w = RequestList(itertools.islice(it, self.window))
            if not w:
                return
            yield w

    @classmethod
    def from_requests(cls, requests: Sequence[Request],
                      window: int = 65536) -> "StreamingRequestSource":
        """Wrap an in-memory trace (tests: stream==materialize audits)."""
        if requests:
            lo = min(r.tr_start for r in requests)
            hi = max(r.tr_end for r in requests)
        else:
            lo = hi = 0.0
        return cls(lambda: iter(requests), window=window,
                   n_requests=len(requests), tr_bounds=(lo, hi))


class StreamingTraceSynthesizer:
    """Generator-based trace synthesizer: yields requests in timestamp
    order at arbitrary scale without materializing the trace.

    Same behavioural model as :class:`TraceGenerator` (program plans via
    the shared :func:`_plan_program_users`, identical per-request
    arithmetic) restructured for streaming:

    - every user gets an independent ``default_rng((seed, uid))`` stream,
      so request values are independent of how user streams interleave
      and of any window size;
    - per-user streams are timestamp-sorted by construction (program
      jitter is clipped to ±0.49·period; the few dozen requests of each
      human user are buffered and sorted up front) and merged with
      :func:`heapq.merge` — peak state is O(n_users), not O(n_requests);
    - ``TraceGenerator``'s post-hoc global volume calibration is a
      whole-trace pass and therefore *not* applied: the streaming
      contract is determinism + exact prefix==materialize equality for
      *this* synthesizer, not byte-equality with ``TraceGenerator``.

    ``n_requests`` truncates the stream exactly; when ``duration`` is not
    given it is solved from the plans' per-second request rates so the
    stream comfortably covers ``n_requests`` (program request counts are
    deterministic given the plans, so a small margin suffices).
    """

    _JITTER_CLIP = 0.49     # × period: preserves per-user ts monotonicity
    _RATE_MARGIN = 1.05

    def __init__(self, profile: TraceProfile, seed: int = 0,
                 n_requests: int | None = None, n_users: int | None = None,
                 duration: float | None = None):
        self.profile = profile
        self.seed = int(seed)
        self.n_requests = n_requests
        self.n_users = int(n_users) if n_users is not None else profile.n_users
        master = np.random.default_rng(self.seed)
        n_human = int(round(self.n_users * profile.human_user_frac))
        self._n_program = self.n_users - n_human
        self._plans = _plan_program_users(profile, master, self._n_program)
        cont_p = _normalize(profile.continent_probs)
        self._continents = [int(c) for c in
                            master.choice(6, size=self.n_users, p=cont_p)]
        self._obj_probs = _zipf_probs(profile.grid.n_objects, alpha=1.0)
        self.duration = float(duration) if duration is not None \
            else self._solve_duration(n_human)
        # Humans are buffered eagerly: O(n_users) memory, and it makes
        # tr_bounds exact (human sessions may run past `duration`).
        self._human_buffers = [
            self._gen_human(len(self._plans) + k,
                            self._continents[len(self._plans) + k])
            for k in range(n_human)
        ]
        tr_hi = self.duration + self._JITTER_CLIP * 6 * HOUR
        for buf in self._human_buffers:
            for r in buf:
                if r.tr_end > tr_hi:
                    tr_hi = r.tr_end
        self.tr_bounds = (0.0, tr_hi)

    # -- sizing --------------------------------------------------------------

    def _solve_duration(self, n_human: int) -> float:
        if self.n_requests is None:
            return self.profile.duration
        rate_reg = sum(pl["n_streams"] / pl["period"] for pl in self._plans
                       if pl["behaviour"] != "realtime")
        rate_rt = sum(pl["n_streams"] / pl["period"] for pl in self._plans
                      if pl["behaviour"] == "realtime")
        # humans contribute a duration-independent request count; use the
        # worst-case draw (1 session × 3 requests) so the solved duration
        # always errs long
        target = self.n_requests * self._RATE_MARGIN - 3 * n_human
        if target <= 0:
            return self.profile.duration
        span_rt = 3 * DAY       # real-time users subsample to this span
        if rate_reg > 0 and \
                (target - span_rt * rate_rt) / rate_reg >= span_rt:
            d = (target - span_rt * rate_rt) / rate_reg
        elif rate_reg + rate_rt > 0:
            d = target / (rate_reg + rate_rt)
        else:
            raise ValueError(
                "no program users: cannot size a duration to reach "
                f"n_requests={self.n_requests}; raise n_users")
        if rate_reg == 0 and d > span_rt:
            raise ValueError(
                f"real-time users cap out at {span_rt * rate_rt:.0f} "
                f"requests; cannot reach n_requests={self.n_requests} — "
                "raise n_users")
        return max(HOUR, d)

    # -- per-user streams ----------------------------------------------------

    def _program_stream(self, uid: int, plan: dict,
                        continent: int) -> Iterator[Request]:
        p = self.profile
        rng = np.random.default_rng((self.seed, uid))
        period, window = plan["period"], plan["window"]
        span = min(self.duration, 3 * DAY) \
            if plan["behaviour"] == "realtime" else self.duration
        start = float(rng.uniform(0, period))
        objs = [int(o) for o in rng.choice(
            p.grid.n_objects, size=plan["n_streams"], replace=False,
            p=self._obj_probs)]
        overlapping = plan["behaviour"] == "overlapping"
        sigma = p.period_jitter_frac * period
        jmax = self._JITTER_CLIP * period
        bps = p.bytes_per_second_stream
        last_end: dict[int, float] = {}
        jit = np.empty(0)
        j = 0
        t = start
        while t < span:
            if j >= jit.shape[0]:
                # block-drawn jitter: one numpy call per 512 ticks
                jit = np.clip(rng.normal(0.0, sigma, 512), -jmax, jmax)
                j = 0
            ts = max(0.0, t + float(jit[j]))
            j += 1
            for obj in objs:
                tr_end = ts
                if overlapping:
                    tr_start = max(0.0, ts - window)
                else:
                    tr_start = last_end.get(obj, max(0.0, ts - window))
                    last_end[obj] = tr_end
                size = int((tr_end - tr_start) * bps)
                yield Request(ts, uid, obj, tr_start, tr_end, size, continent)
            t += period

    def _gen_human(self, uid: int, continent: int) -> list[Request]:
        # mirrors TraceGenerator._gen_human_requests with a per-user rng
        p = self.profile
        g = p.grid
        rng = np.random.default_rng((self.seed, uid))
        n_sessions = int(rng.integers(1, 4))
        out: list[Request] = []
        type_pop = _zipf_probs(g.n_types)
        for _ in range(n_sessions):
            t0 = float(rng.uniform(0, self.duration))
            loc = int(rng.integers(0, g.n_locs))
            itype = int(rng.choice(g.n_types, p=type_pop))
            n_req = int(rng.integers(3, 12))
            t = t0
            for _ in range(n_req):
                if rng.random() < 0.5:
                    itype = int(rng.choice(g.n_types, p=type_pop))
                else:
                    loc = int(np.clip(loc + rng.integers(-2, 3), 0, g.n_locs - 1))
                obj = g.obj_id(itype, loc)
                window = float(rng.choice([HOUR, 6 * HOUR, DAY]))
                tr_end = float(rng.uniform(0, max(1.0, t - 1.0))) if t > 2 else t
                tr_start = max(0.0, tr_end - window)
                size = int((tr_end - tr_start) * p.bytes_per_second_stream * 0.1)
                out.append(Request(t, uid, obj, tr_start, tr_end, size,
                                   continent))
                t += float(rng.exponential(120.0))
        out.sort(key=lambda r: r.ts)
        return out

    # -- public API ----------------------------------------------------------

    def iter_requests(self) -> Iterator[Request]:
        """One pass over the stream, timestamp-sorted, truncated at
        ``n_requests``.  Re-entrant: every call restarts from scratch and
        yields the identical sequence."""
        streams: list[Iterator[Request]] = [
            self._program_stream(uid, plan, self._continents[uid])
            for uid, plan in enumerate(self._plans)
        ]
        streams.extend(iter(buf) for buf in self._human_buffers)
        merged = heapq.merge(*streams, key=lambda r: r.ts)
        if self.n_requests is not None:
            merged = itertools.islice(merged, self.n_requests)
        return merged

    def materialize(self, n: int | None = None) -> RequestList:
        """The first ``n`` requests (all, if None) as a ``RequestList`` —
        by construction the exact prefix of :meth:`iter_requests`."""
        return RequestList(itertools.islice(self.iter_requests(), n))

    def source(self, window: int = 65536) -> StreamingRequestSource:
        return StreamingRequestSource(
            self.iter_requests, window=window, n_requests=self.n_requests,
            tr_bounds=self.tr_bounds)
