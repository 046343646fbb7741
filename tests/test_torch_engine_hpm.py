"""Replay counters of the port against ``repro`` for the strategies that
predict through ARIMA, and streamed == materialized inside the port.

``hpm`` is held twice: with ``repro``'s planned op stream injected into the
port's engine (the engine alone), and end to end on the seeded traces.
``md2`` predicts online through the ARIMA fit on every request; its fits
are ill-conditioned (short, heavy-tailed gap series), so cross-framework
ulps change its forecasts and with them its counters.  It is held with
``repro``'s forecasts injected, which shows the engine is exact and the
divergence lives in the fit.  Integer counters are identical, never close.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as J
from repro.core.arima import ARIMA as JARIMA
import repro_torch.core as T
import repro_torch.core.arima as TA
from repro_torch import convert
from test_torch_engine import _cfg, _counters, _profile, _run_both, _split


def _plan_tuples(plan):
    ops = [[dataclasses.astuple(op) for op in r] for r in plan.ops]
    return ops, [list(r) for r in plan.subscriptions]


@pytest.mark.parametrize("trace", ["ooi", "gage", "arima"])
def test_hpm_with_injected_plan_identical(trace):
    """The port's engine replays ``repro``'s planned op stream to
    ``repro``'s counters: any hpm divergence is the planner's."""
    train_j, test_j = _split(J, trace)
    train_t, test_t = _split(T, trace)
    ref = J.run_strategy("hpm", test_j, _profile(J, trace).grid,
                         _cfg(J, trace, test_j), train_j)
    plan_j = J.make_prefetcher("hpm", _profile(J, trace).grid,
                               train_j).plan(test_j)
    injected = convert.prefetch_plan_from_tuples(*_plan_tuples(plan_j))
    pf = T.make_prefetcher("hpm", _profile(T, trace).grid, train_t,
                           device="cpu")
    pf.plan = lambda requests: injected
    sim = T.VectorVDCSimulator(_profile(T, trace).grid, pf,
                               _cfg(T, trace, test_t), device="cpu")
    res = sim.run(test_t, name="hpm")
    assert res.prefetch_issued_chunks > 0
    assert _counters(res) == _counters(ref)


@pytest.mark.parametrize("trace", ["ooi", "gage"])
def test_hpm_end_to_end_identical(trace):
    rj, rt = _run_both("hpm", trace)
    assert rt.prefetch_issued_chunks > 0
    assert _counters(rt) == _counters(rj)


@pytest.mark.parametrize("trace", ["ooi", "gage"])
def test_md2_with_injected_forecasts_identical(trace, monkeypatch):
    reference = JARIMA(n=60, bank=False)
    calls = []

    def forecast(self, series):
        calls.append(len(series))
        return reference.forecast_next(series)

    monkeypatch.setattr(TA.ARIMA, "forecast_next", forecast)
    rj, rt = _run_both("md2", trace)
    assert len(calls) > 0
    assert _counters(rt) == _counters(rj)


def _int_counters(res):
    agg = res.outcome_totals()
    return (_counters(res), res.total_requests, agg.n_bytes_pos,
            tuple(sorted((d, s.hit_bytes, s.miss_bytes)
                         for d, s in res.cache_stats.items())))


@pytest.mark.parametrize("strategy", ["cache_only", "hpm"])
@pytest.mark.parametrize("trace", ["ooi", "arima"])
def test_streamed_equals_materialized(trace, strategy):
    train, test = _split(T, trace)
    grid = _profile(T, trace).grid
    mat = T.run_strategy(strategy, test, grid, _cfg(T, trace, test), train,
                         device="cpu")
    src = T.StreamingRequestSource.from_requests(test, window=997)
    stream = T.run_strategy(strategy, src, grid, _cfg(T, trace, test), train,
                            device="cpu")
    assert _int_counters(stream) == _int_counters(mat)
    a, b = mat.outcome_totals(), stream.outcome_totals()
    for f in ("latency_sum", "transfer_sum", "throughput_sum"):
        x, y = getattr(a, f), getattr(b, f)
        assert abs(x - y) <= 1e-9 * max(1.0, abs(x)), f
    assert np.isfinite(b.latency_sum)
