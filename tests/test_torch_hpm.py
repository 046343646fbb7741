"""The port's two-phase HPM planner against ``repro``'s, op for op.

On the seeded OOI and GAGE traces every program user's gaps take the median
fast path, so the op streams are bitwise equal.  The jittered-period trace
sends hundreds of series through the ARIMA bank: there the deferred series
are identical, the port's planner fed ``repro``'s forecasts emits
``repro``'s op stream bit for bit, and with its own forecasts only the
timestamps of bank-forecast ops move.  Those agree within 5e-2 of the
predicted gap: these series are jittered schedules whose 60-step fits are
ill-conditioned, so the cross-framework forecast gap reaches ~3e-2 on a few
of them (``test_torch_arima`` holds the fit itself at 1e-3 on
well-conditioned series).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import hpm as JH
from repro.core import trace as JT
from repro_torch.core import hpm as TH
from repro_torch.core import trace as TT

STEPS = 60


def _split(mod, trace):
    if trace == "arima":
        profile = dataclasses.replace(
            mod.OOI_PROFILE, name="ooi_arima", n_users=6, human_user_frac=0.2,
            type_volume_mix=(0.9, 0.05, 0.05), period_jitter_frac=0.06,
            duration=mod.WEEK)
        tr = mod.TraceGenerator(profile, seed=3).generate()
    else:
        tr = mod.make_trace(trace, seed=0, scale={"ooi": 0.04,
                                                  "gage": 0.08}[trace])
    cut = int(len(tr) * 0.3)
    return tr[:cut], tr[cut:]


def _planner(mod, train, **kw):
    model = mod.HybridPrefetcher(
        rule_transactions=mod.build_rule_transactions(train), **kw)
    model.arima.steps = STEPS
    deferred = []
    inner = model.arima.batched_forecast

    def recording(series_list):
        out = inner(series_list)
        deferred.append(([np.asarray(s) for s in series_list], out))
        return out

    model.arima.batched_forecast = recording
    return mod.BatchedHPMPlanner(model), deferred


def _tuples(plan):
    return [[dataclasses.astuple(op) for op in ops] for ops in plan]


def _plans(trace):
    train_j, test_j = _split(JT, trace)
    train_t, test_t = _split(TT, trace)
    pj, dj = _planner(JH, train_j)
    pt, dt = _planner(TH, train_t, device="cpu")
    return (_tuples(pj.plan(test_j)), dj), (_tuples(pt.plan(test_t)), dt), \
        (train_t, test_t)


@pytest.mark.parametrize("trace", ["ooi", "gage"])
def test_op_stream_identical_on_seeded_traces(trace):
    (ops_j, dj), (ops_t, dt), _ = _plans(trace)
    assert sum(map(len, ops_j)) > 0
    assert ops_t == ops_j
    assert len(dj) == len(dt)
    assert sum(len(s) for s, _ in dt) == sum(len(s) for s, _ in dj)


def test_op_stream_on_arima_trace():
    (ops_j, dj), (ops_t, dt), (train_t, test_t) = _plans("arima")
    # phase 1 is host code: the deferred series are the same floats
    (series_j, fc_j), = dj
    (series_t, fc_t), = dt
    assert len(series_t) == len(series_j) > 100
    assert all(np.array_equal(a, b) for a, b in zip(series_j, series_t))

    # fed repro's forecasts, the port's planner emits repro's stream exactly
    pt, _ = _planner(TH, train_t, device="cpu")
    pt.model.arima.batched_forecast = lambda series_list: fc_j.copy()
    assert _tuples(pt.plan(test_t)) == ops_j

    # with its own forecasts: (user, obj, reason) and the op count exact;
    # only history ops (the bank's) may move, by at most 5e-2 of the gap
    # from the request to the predicted timestamp
    assert len(ops_t) == len(ops_j)
    for a, b in zip(ops_j, ops_t):
        assert [(o[1], o[2], o[5]) for o in a] == \
            [(o[1], o[2], o[5]) for o in b]
        for x, y in zip(a, b):
            assert y[4] - y[3] == pytest.approx(x[4] - x[3], abs=1e-6)
            if x != y:
                assert x[5] == "history"
                # tr_end = next_ts and issue = now + 0.8 (next_ts - now)
                gap = (x[4] - x[0]) / 0.2
                assert abs(y[4] - x[4]) <= 5e-2 * abs(gap) + 1e-6
    rel = np.abs(fc_t - fc_j) / np.abs(fc_j)
    assert np.median(rel) < 1e-3
