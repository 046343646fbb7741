"""ARIMA in the port: the hand-derived gradient against autograd, the plain
fit against ``repro``'s JAX bank, and the bank's online == batched contract
inside the port (bitwise).

Tolerances: the hand-derived gradient adds the same terms in the same order
as autograd, so it is held bit for bit.  Forecasts across the two frameworks are held at rtol
1e-3 with 60 Adam steps on well-conditioned series (a periodic gap pattern
with small noise): XLA and PyTorch round the mean, the dot products and
``0.9 ** t`` differently, and the Adam trajectory amplifies those ulps.  On
white-noise gaps the fit is ill-conditioned and the same ulps grow past
1e-2 within 60 steps, which is why those series are compared only inside
the port, bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.core import arima as J
from repro_torch.core import arima as T
from repro_torch.kernels import arima_bank as K

_MODEL = T.ARIMA(n=16, steps=60, device="cpu")


def _noisy(rng, n_rows, n):
    return [rng.normal(3600.0, 400.0, size=n).astype(np.float32)
            for _ in range(n_rows)]


def _periodic(rng, n_rows, n):
    t = np.arange(n)
    return [(3600.0 + 400.0 * np.sin(2 * np.pi * t / rng.uniform(5.0, 9.0)
                                      + rng.uniform(0.0, 6.0))
             + rng.normal(0.0, 60.0, size=n)).astype(np.float32)
            for _ in range(n_rows)]


@pytest.mark.parametrize("order,n", [((2, 1, 1), 16), ((2, 1, 1), 60),
                                     ((1, 2, 0), 32), ((3, 0, 2), 16),
                                     ((0, 1, 3), 8), ((4, 2, 4), 24)])
def test_css_grad_manual_matches_autograd(order, n):
    p, d, q = order
    rng = np.random.default_rng(n + 10 * p + 100 * q)
    y = torch.from_numpy(rng.normal(3600, 400, size=(6, n)).astype(np.float32))
    yd, _, _, _ = K._prepare(y, d)
    w = torch.from_numpy(
        rng.normal(0.0, 0.3, size=(6, 1 + p + q)).astype(np.float32))
    w.requires_grad_(True)
    (g_auto,) = torch.autograd.grad(K.css_loss(w, yd, p, q, n).sum(), w)
    g_man = K.css_grad_manual(w.detach(), yd, p, q, n)
    assert torch.equal(g_man, g_auto)


@pytest.mark.parametrize("bucket", [4, 8, 16, 32, 60])
def test_plain_fit_matches_repro_bank(bucket):
    rng = np.random.default_rng(11 + bucket)
    series = _periodic(rng, 32, bucket)
    n = max(16, bucket)
    ref = J.ARIMA(n=n, steps=60).batched_forecast(series)
    got = T.ARIMA(n=n, steps=60, device="cpu").batched_forecast(series)
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_d2_quadratic_trend_matches_repro_and_numpy():
    """A quadratic trend has a constant second difference: d=2 must
    extrapolate it (NumPy reference, the JAX package's test tolerance)."""
    t = np.arange(40, dtype=np.float64)
    y = (3.0 + 2.0 * t + 0.5 * t * t).astype(np.float32)
    ref = J.ARIMA(order=J.ARIMAOrder(p=1, d=2, q=0), n=32).forecast_next(y)
    got = T.ARIMA(order=T.ARIMAOrder(p=1, d=2, q=0), n=32,
                  device="cpu").forecast_next(y)
    assert got == pytest.approx(ref, rel=1e-3)
    yd = y.astype(np.float64)
    expect = yd[-1] + (yd[-1] - yd[-2]) + float(np.diff(yd, n=2)[-1])
    assert got == pytest.approx(expect, rel=1e-2)


def _ragged_series(seed):
    rng = np.random.default_rng(seed)
    out = []
    for size in [0, 1, 3, 4, 5, 7, 8, 9, 15, 16, 20, 2, 12, 16, 6]:
        out.append(rng.normal(3600.0, 400.0, size=size).astype(np.float32))
    out += _noisy(rng, 33, 16)               # a padded second bank group
    out.append(np.full(10, 42.0, np.float32))          # sd clamp
    # finite values whose sum overflows: the fit is non-finite and the
    # forecast falls back to the median
    out.append(rng.uniform(1.0e38, 1.6e38, size=12).astype(np.float32))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_online_equals_batched_bitwise(seed):
    series = _ragged_series(seed)
    batched = _MODEL.batched_forecast(series)
    online = [_MODEL.forecast_next(s) for s in series]
    assert batched.tolist() == online
    assert batched[0] == 0.0 and batched[1] == series[1][-1]
    assert batched[-1] == float(np.median(series[-1][-8:]))
    scalar = T.ARIMA(n=16, steps=60, bank=False, device="cpu")
    assert scalar.batched_forecast(series[:20]).tolist() == online[:20]


def test_bank_rows_independent_of_batch_composition():
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.normal(3600, 400, size=(40, 16)).astype(np.float32))
    full = K.arima_bank(y, (2, 1, 1), 60, 0.05)
    rev = K.arima_bank(y.flip(0).contiguous(), (2, 1, 1), 60, 0.05).flip(0)
    alone = torch.cat([K.arima_bank(y[i:i + 1].contiguous(), (2, 1, 1), 60,
                                    0.05) for i in range(0, 40, 7)])
    assert torch.equal(full, rev)
    assert torch.equal(full[::7], alone)


@pytest.mark.parametrize("seed", [0, 1])
def test_predict_next_timestamps_matches_scalar(seed):
    rng = np.random.default_rng(seed)
    series = [np.cumsum([1000.0] + rng.uniform(1.0, 5e3, size=k).tolist())
              for k in (0, 1, 2, 3, 5, 9, 17, 30)]
    series.append(np.cumsum([100.0] + [3600.0, 3600.2, 3599.9, 3600.1] * 5))
    batched = T.predict_next_timestamps(series, _MODEL)
    assert batched.tolist() == [T.predict_next_timestamp(ts, _MODEL)
                                for ts in series]


def test_fast_path_equals_repro_exactly():
    """The median fast path and the clamp make bitwise decisions: the port
    keeps the JAX package's helpers verbatim, so these agree exactly."""
    rng = np.random.default_rng(9)
    jm = J.ARIMA(n=16, steps=60)
    for k in range(30):
        base = rng.uniform(60.0, 7200.0)
        ts = np.cumsum([rng.uniform(0, 1e5)] +
                       (base + rng.normal(0.0, base * 0.003, 25)).tolist())
        assert T.predict_next_timestamp(ts, _MODEL) == \
            J.predict_next_timestamp(ts, jm)
        assert T.predict_next_timestamps([ts, ts[:2], ts[:1]], _MODEL
                                         ).tolist() == \
            J.predict_next_timestamps([ts, ts[:2], ts[:1]], jm).tolist()
        g = np.diff(ts).tolist()
        assert T._gap_stats(g) == J._gap_stats(g)
        args = (float(ts[-1]), float(rng.normal(0, 5e3)), float(max(g)))
        assert T.clamp_forecast_gap(*args) == J.clamp_forecast_gap(*args)


@pytest.mark.parametrize("bad", ["float64", "strided", "long", "p5", "d3",
                                 "short", "vector"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    y = torch.zeros(4, 16)
    order = (2, 1, 1)
    if bad == "float64":
        y = y.double()
    elif bad == "strided":
        y = torch.zeros(16, 4).T
    elif bad == "long":
        y = torch.zeros(4, 65)
    elif bad == "p5":
        order = (5, 1, 1)
    elif bad == "d3":
        order = (2, 3, 1)
    elif bad == "short":
        y, order = torch.zeros(4, 3), (2, 2, 1)
    elif bad == "vector":
        y = torch.zeros(16)
    with pytest.raises((TypeError, ValueError)):
        K.arima_bank(y, order, 10, 0.05)


def test_plain_path_counts_no_launch():
    K.reset_counts()
    _MODEL.batched_forecast(_noisy(np.random.default_rng(2), 3, 16))
    assert K.LAUNCHES == 0 and K.ROWS == 0
