"""Replay counters of the port's engines against ``repro``'s vector engine
for the strategies without ARIMA (``test_torch_engine_hpm.py`` holds the
rest).  Integer counters must be *identical* (no tolerance).
"""
import dataclasses

import pytest

import repro.core as J
import repro_torch.core as T

SCALES = {"ooi": 0.04, "gage": 0.08}
CONFIGS = {"default": {}, "thrash": {"cache_bytes": 1 << 24},
           "lfu": {"cache_policy": "lfu", "cache_bytes": 1 << 26}}


def _arima_profile(mod):
    return dataclasses.replace(
        mod.OOI_PROFILE, name="ooi_arima", n_users=6, human_user_frac=0.2,
        type_volume_mix=(0.9, 0.05, 0.05), period_jitter_frac=0.06,
        duration=7 * 24 * 3600.0)


def _split(mod, trace):
    if trace == "arima":
        tr = mod.TraceGenerator(_arima_profile(mod), seed=3).generate()
    else:
        tr = mod.make_trace(trace, seed=0, scale=SCALES[trace])
    cut = int(len(tr) * 0.3)
    return tr[:cut], tr[cut:]


def _profile(mod, trace):
    if trace == "arima":
        return _arima_profile(mod)
    return {"ooi": mod.OOI_PROFILE, "gage": mod.GAGE_PROFILE}[trace]


def _cfg(mod, trace, test, **kw):
    return mod.SimConfig(
        stream_rate_bytes_per_s=_profile(mod, trace).bytes_per_second_stream,
        **kw).calibrate_origin(test)


def _counters(res):
    agg = res.outcome_totals()
    return (res.origin_requests, res.prefetch_issued_chunks,
            res.prefetch_used_chunks, res.stream_pushes,
            tuple(sorted((d, s.hits, s.misses, s.evictions, s.inserted_bytes)
                         for d, s in res.cache_stats.items())),
            agg.n, agg.bytes, agg.local_bytes, agg.prefetched_bytes,
            agg.peer_bytes, agg.origin_bytes)


def _run_both(strategy, trace, engine_t="vector", **kw):
    train_j, test_j = _split(J, trace)
    train_t, test_t = _split(T, trace)
    rj = J.run_strategy(strategy, test_j, _profile(J, trace).grid,
                        _cfg(J, trace, test_j, **kw), train_j)
    rt = T.run_strategy(strategy, test_t, _profile(T, trace).grid,
                        _cfg(T, trace, test_t, **kw), train_t,
                        engine=engine_t, device="cpu")
    return rj, rt


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("strategy", ["no_cache", "cache_only", "md1"])
@pytest.mark.parametrize("trace", ["ooi", "gage"])
def test_counters_identical(trace, strategy, config):
    rj, rt = _run_both(strategy, trace, **CONFIGS[config])
    assert _counters(rt) == _counters(rj)
    if config == "thrash" and strategy != "no_cache":
        assert sum(s.evictions for s in rt.cache_stats.values()) > 0


@pytest.mark.parametrize("strategy", ["cache_only", "md1"])
def test_reference_engine_counters_identical(strategy):
    rj, rt = _run_both(strategy, "gage", engine_t="reference")
    assert _counters(rt) == _counters(rj)
