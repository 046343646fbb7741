"""The port's interval engine against ``repro``'s and against the port's
own vector engine.

Every case runs both packages on the same seeded trace and config and
records which of the engine's routes ran (fused block replay, sequential
sweep, windowed interval replay, delegation to the vector engine).  The
planner's choice between the fused replay and the sweep is pinned, where a
case asks for one route, through ``SWEEP_MIN_CHUNKS_PER_REQ`` in both
packages.  Held identical, never close: integer counters, the eviction
telemetry of ``SimResult``, ``IntervalVDCSimulator.last_peer_fetches`` and
the route taken.  The port's interval counters must also equal the port's
vector engine on the same inputs (contract #1).
"""
import pytest

import repro.core as J
import repro_torch.core as T
from repro_torch import convert
from test_torch_engine import _cfg, _counters, _profile, _split
from test_torch_engine_hpm import _plan_tuples

CONFIGS = {"default": {}, "thrash": {"cache_bytes": 1 << 24},
           "fine": {"chunk_seconds": 60.0}}
ROUTES = ("_run_fused", "_run_sweep", "_run_stream_interval")
#: ``SWEEP_MIN_CHUNKS_PER_REQ`` per pinned route (``planner``: the default)
PINS = {"planner": None, "fused": float("inf"), "sweep": 0.0}


def _telemetry(res) -> tuple:
    return (res.evict_plan_calls, res.block_truncations,
            res.degenerate_serves, res.block_phases, res.inblock_victims)


def _pin(monkeypatch, route: str) -> None:
    """Make both packages' planners take ``route`` (fused or sweep)."""
    if PINS[route] is not None:
        for mod in (J, T):
            monkeypatch.setattr(mod.IntervalVDCSimulator,
                                "SWEEP_MIN_CHUNKS_PER_REQ", PINS[route])


@pytest.fixture
def routes(monkeypatch):
    """Record, per package, the routes each interval run took (in call
    order; ``vector`` for the inherited vector paths) and the last
    simulator that ran."""
    seen = {J: [], T: []}
    sims = {}
    for mod in (J, T):
        cls = mod.IntervalVDCSimulator

        def wrap(name, inner, log):
            def recording(self, *a, **k):
                log.append(name)
                return inner(self, *a, **k)
            return recording

        for name in ROUTES:
            monkeypatch.setattr(cls, name,
                                wrap(name, getattr(cls, name), seen[mod]))

        def run(self, *a, _inner=cls.run, _mod=mod, **k):
            sims[_mod] = self
            return _inner(self, *a, **k)

        monkeypatch.setattr(cls, "run", run)

        def vector_run(self, *a, _inner=mod.VectorVDCSimulator.run,
                       _log=seen[mod], **k):
            _log.append("vector")
            return _inner(self, *a, **k)

        monkeypatch.setattr(mod.VectorVDCSimulator, "run", vector_run)
    return seen, sims


def _both(strategy, trace, routes, source=None, **kw):
    """One interval run per package on the seeded split; ``source`` turns
    the test trace into a streamed one.  Returns the two results after
    checking routes, telemetry and peer fetches are identical."""
    seen, sims = routes
    out = {}
    for mod in (J, T):
        train, test = _split(mod, trace)
        reqs = test if source is None else source(mod, test)
        dev = {} if mod is J else {"device": "cpu"}
        out[mod] = mod.run_strategy(strategy, reqs, _profile(mod, trace).grid,
                                    _cfg(mod, trace, test, **kw), train,
                                    engine="interval", **dev)
    assert seen[T] == seen[J] and seen[T]
    assert _telemetry(out[T]) == _telemetry(out[J])
    assert sims[T].last_peer_fetches == sims[J].last_peer_fetches
    assert _counters(out[T]) == _counters(out[J])
    return out[J], out[T]


_VECTOR: dict = {}


def _port_vector(strategy, trace, **kw):
    """The port's vector engine on the same split and config (shared by
    the cases that differ only in the interval engine's route)."""
    key = (strategy, trace, tuple(sorted(kw.items())))
    if key not in _VECTOR:
        train, test = _split(T, trace)
        _VECTOR[key] = _counters(T.run_strategy(
            strategy, test, _profile(T, trace).grid,
            _cfg(T, trace, test, **dict(key[2])), train, device="cpu"))
    return _VECTOR[key]


@pytest.mark.parametrize("route", sorted(PINS))
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("trace", ["ooi", "gage"])
def test_static_interval_identical(trace, config, route, routes,
                                   monkeypatch):
    _pin(monkeypatch, route)
    kw = CONFIGS[config]
    _, rt = _both("cache_only", trace, routes, **kw)
    seen = list(routes[0][T])
    assert _counters(rt) == _port_vector("cache_only", trace, **kw)
    if route == "planner":
        # the planner's regime: at 60 s chunks GAGE's test split averages
        # ~275 chunks per request (past SWEEP_MIN_CHUNKS_PER_REQ), OOI's ~34
        sweep = config == "fine" and trace == "gage"
        route = "sweep" if sweep else "fused"
    assert seen == ["_run_" + route]
    if config == "thrash":
        assert sum(s.evictions for s in rt.cache_stats.values()) > 0


@pytest.mark.parametrize("tr_bounds", [True, False])
@pytest.mark.parametrize("route", ["planner", "sweep"])
@pytest.mark.parametrize("config", ["default", "thrash"])
def test_streamed_interval_identical(config, route, tr_bounds, routes,
                                     monkeypatch):
    _pin(monkeypatch, route)

    def source(mod, test):
        src = mod.StreamingRequestSource.from_requests(test, window=997)
        if not tr_bounds:
            src.tr_bounds = None
        return src

    kw = CONFIGS[config]
    _, rt = _both("cache_only", "ooi", routes, source=source, **kw)
    assert routes[0][T] == (["_run_stream_interval"] if tr_bounds
                            else ["vector"])
    assert _counters(rt) == _port_vector("cache_only", "ooi", **kw)


@pytest.mark.parametrize("strategy,kw", [
    ("md1", {}), ("no_cache", {}),
    ("cache_only", {"cache_policy": "lfu", "cache_bytes": 1 << 26})])
@pytest.mark.parametrize("trace", ["ooi", "gage"])
def test_delegated_strategies_identical(trace, strategy, kw, routes):
    _, rt = _both(strategy, trace, routes, **kw)
    assert routes[0][T] == ["vector"]
    assert _counters(rt) == _port_vector(strategy, trace, **kw)


@pytest.mark.parametrize("trace", ["ooi", "gage"])
def test_hpm_with_injected_plan_delegates_identically(trace, routes):
    """``hpm`` delegates to the vector engine; with ``repro``'s planned op
    stream injected, the port's interval engine gives ``repro``'s
    interval counters (the planner's cross-framework drift is held
    elsewhere)."""
    seen = routes[0]
    train_j, test_j = _split(J, trace)
    train_t, test_t = _split(T, trace)
    ref = J.run_strategy("hpm", test_j, _profile(J, trace).grid,
                         _cfg(J, trace, test_j), train_j, engine="interval")
    plan_j = J.make_prefetcher("hpm", _profile(J, trace).grid,
                               train_j).plan(test_j)
    injected = convert.prefetch_plan_from_tuples(*_plan_tuples(plan_j))
    pf = T.make_prefetcher("hpm", _profile(T, trace).grid, train_t,
                           device="cpu")
    pf.plan = lambda requests: injected
    res = T.IntervalVDCSimulator(_profile(T, trace).grid, pf,
                                 _cfg(T, trace, test_t),
                                 device="cpu").run(test_t, name="hpm")
    assert seen[T] == seen[J] == ["vector"]
    assert res.prefetch_issued_chunks > 0
    assert _counters(res) == _counters(ref)
    assert _telemetry(res) == _telemetry(ref)


# ---------------------------------------------------------------------------
# cross-DTN traces: real peer traffic and the peer-before-origin insert order
# ---------------------------------------------------------------------------

_U = 1 << 20


def _peer_heavy(mod):
    """An NA user warms object 0's moving window and an EU user replays it
    shortly after: the NA->EU link beats EU's origin link, so the replays
    are peer fetches."""
    t = 3600.0 * 40
    out = []
    for i in range(40):
        ts = t + i * 3600.0
        lo = ts - 8 * 3600.0 - t
        out.append(mod.Request(ts, 1, 0, lo, lo + 8 * 3600.0, 64 * _U, 0))
        out.append(mod.Request(ts + 60, 2, 0, lo, lo + 8 * 3600.0, 64 * _U,
                               2))
        if i % 3 == 0:
            out.append(mod.Request(ts + 120, 3, 0, max(0.0, lo - 30 * 3600.0),
                                   max(1.0, lo - 20 * 3600.0), 48 * _U, 2))
    out.sort(key=lambda r: r.ts)
    return mod.ObjectGrid(4, 4), mod.RequestList(out), 128 * _U, 3600.0


def _order_sensitive(mod):
    """The EU request at t=102 misses one run from the origin and one from
    the NA peer, and the eviction at t=103 consumes one whole insert
    record: which chunks it evicts depends on the reference inserting the
    peer-fetched run before the origin run."""
    R = mod.Request
    return mod.ObjectGrid(2, 2), mod.RequestList([
        R(100.0, 1, 0, 10.0, 15.0, 5 * _U, 0),
        R(101.0, 2, 0, 5.0, 10.0, 5 * _U, 2),
        R(102.0, 2, 0, 0.0, 15.0, 15 * _U, 2),
        R(103.0, 2, 0, 20.0, 30.0, 10 * _U, 2),
        R(104.0, 2, 0, 10.0, 15.0, 5 * _U, 2),
    ]), 15 * _U, 1.0


@pytest.mark.parametrize("peer", [True, False])
@pytest.mark.parametrize("route", sorted(PINS))
@pytest.mark.parametrize("make", [_peer_heavy, _order_sensitive],
                         ids=["peer_heavy", "order_sensitive"])
def test_cross_dtn_identical(make, route, peer, routes, monkeypatch):
    _pin(monkeypatch, route)
    seen, sims = routes
    out = {}
    for mod in (J, T):
        grid, trace, cap, cs = make(mod)
        cfg = mod.SimConfig(stream_rate_bytes_per_s=8e3, cache_bytes=cap,
                            chunk_seconds=cs,
                            enable_peer_cache=peer).calibrate_origin(trace)
        dev = {} if mod is J else {"device": "cpu"}
        out[mod] = mod.run_strategy("cache_only", trace, grid, cfg, None,
                                    engine="interval", **dev)
        out[mod, "vector"] = mod.run_strategy("cache_only", trace, grid, cfg,
                                              None, **dev)
    assert seen[T] == seen[J]
    assert sims[T].last_peer_fetches == sims[J].last_peer_fetches
    assert _counters(out[T]) == _counters(out[J]) == \
        _counters(out[T, "vector"])
    assert _telemetry(out[T]) == _telemetry(out[J])
    peer_bytes = out[T].outcome_totals().peer_bytes
    assert (peer_bytes > 0) == peer
    if peer:
        assert sims[T].last_peer_fetches
    if route != "planner":
        assert seen[T] == ["_run_" + route, "vector"]
