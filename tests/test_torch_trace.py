"""Trace synthesis in the port is bit-identical to ``repro``'s: both draw
from NumPy's ``default_rng`` in the same order."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import trace as J
from repro_torch import convert
from repro_torch.core import trace as T


def _columns(requests):
    return [np.array([getattr(r, f.name) for r in requests])
            for f in dataclasses.fields(T.Request)]


@pytest.mark.parametrize("name,seed,scale", [
    ("ooi", 0, 0.04), ("ooi", 7, 0.035), ("gage", 0, 0.08), ("gage", 3, 0.05),
])
def test_make_trace_identical(name, seed, scale):
    a = J.make_trace(name, seed=seed, scale=scale)
    b = T.make_trace(name, seed=seed, scale=scale)
    assert len(a) == len(b) > 0
    for x, y in zip(_columns(a), _columns(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    ja, ta = J.requests_to_arrays(a), T.requests_to_arrays(b)
    for f in dataclasses.fields(T.RequestArrays):
        assert np.array_equal(getattr(ja, f.name), getattr(ta, f.name))


@pytest.mark.parametrize("profile", ["ooi", "gage"])
def test_streamed_prefix_identical(profile):
    jp = {"ooi": J.OOI_PROFILE, "gage": J.GAGE_PROFILE}[profile]
    tp = {"ooi": T.OOI_PROFILE, "gage": T.GAGE_PROFILE}[profile]
    kw = dict(seed=5, n_requests=3000, n_users=200)
    js = J.StreamingTraceSynthesizer(jp, **kw)
    ts = T.StreamingTraceSynthesizer(tp, **kw)
    a = [dataclasses.astuple(r) for r in itertools.islice(js.iter_requests(), 1500)]
    b = [dataclasses.astuple(r) for r in itertools.islice(ts.iter_requests(), 1500)]
    assert a == b
    assert js.tr_bounds == ts.tr_bounds
    wa = [len(w) for w in js.source(window=613).windows()]
    wb = [len(w) for w in ts.source(window=613).windows()]
    assert wa == wb


def test_requests_from_arrays_round_trip():
    a = J.make_trace("gage", seed=2, scale=0.05)
    arr = J.requests_to_arrays(a)
    b = convert.requests_from_arrays(arr.ts, arr.user_id, arr.obj,
                                     arr.tr_start, arr.tr_end,
                                     arr.size_bytes, arr.continent)
    assert isinstance(b, T.RequestList)
    assert [dataclasses.astuple(r) for r in a] == \
        [dataclasses.astuple(r) for r in b]
    with pytest.raises(ValueError):
        convert.requests_from_arrays([0.0], [1, 2], [0], [0.0], [1.0], [8], [0])
