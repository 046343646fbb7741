"""ARIMA(p, d, q) time-series model (paper §IV-A2), fitted on the device.

The paper uses ARIMA to predict the timestamp of a program user's next
request, training on the n=60 most recent points.  The fit is a standard
conditional-sum-of-squares (CSS) fit:

- difference the series ``d`` times,
- compute one-step-ahead residuals of the ARMA(p, q) recursion
  ``e_t = y_t - c - Σ φ_i·y_{t-i} - Σ θ_j·e_{t-j}``,
- minimize ``Σ e_t²`` with Adam steps,
- forecast by iterating the recursion with future residuals set to zero and
  un-differencing through the saved per-level tails.

Batched execution (the ARIMA *bank*)
------------------------------------

Every forecast — scalar ``forecast_next`` and :meth:`ARIMA.batched_forecast`
alike — runs through the ARIMA bank kernel
(:mod:`repro_torch.kernels.arima_bank`: hand-written CUDA on a CUDA device,
its plain PyTorch version on the CPU).  Series are bucketed by history
length and packed into fixed-width groups of :data:`BANK_WIDTH` rows, short
groups padded by repeating their first row; :func:`pack_bank` lays every
bucket into one buffer, longest history first, and the whole batch is ONE
launch (one copy in, one launch, one copy out).  The kernel computes every
row on its own, so a row's forecast is bitwise identical whatever the batch
holds, and the scalar and batched paths return *exactly* the same floats
for the same series: the batched HPM planner's op stream equals the online
``observe`` loop op for op.  Across frameworks the forecasts agree only to
a tolerance: the 200-step Adam trajectory amplifies any ulp difference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.arima_bank import (WARP, arima_bank,
                                            arima_bank_segments,
                                            segment_table)

# Fixed group width of the bank.  Rows are independent in the kernel, so the
# width changes no result; it is kept so that the padding semantics match
# the JAX package's bank, and it is the kernel's warp of rows, so every
# bucket's segment starts on a warp.
BANK_WIDTH = WARP

# History-length buckets: a series is truncated to the largest bucket that
# fits.  ``ARIMA.n`` caps the last bucket.
_BUCKETS = (4, 8, 16, 32)


def pack_bank(buckets: dict[int, list[np.ndarray]]
              ) -> tuple[np.ndarray, list[tuple[int, int, int]]]:
    """One buffer for a whole bank batch: for each history length ``n``,
    longest first, its rows (each ``n`` float32 values) in ``BANK_WIDTH``-row
    groups, a short group padded by repeating its first row.  Returns the
    flat float32 buffer and its segment table (``(row offset, rows, n)``,
    :func:`repro_torch.kernels.arima_bank.segment_table`); bucket ``n``'s
    ``j``-th row is row ``offset + j``."""
    parts, sizes = [], {}
    for n in sorted(buckets, reverse=True):
        tasks = buckets[n]
        n_groups = -(-len(tasks) // BANK_WIDTH)
        rows = np.empty((n_groups * BANK_WIDTH, n), np.float32)
        rows[:len(tasks)] = tasks
        for lo in range(0, len(tasks), BANK_WIDTH):
            hi = min(lo + BANK_WIDTH, len(tasks))
            rows[hi:lo + BANK_WIDTH] = rows[lo]
        parts.append(rows.reshape(-1))
        sizes[n] = len(rows)
    return np.concatenate(parts), segment_table(sizes)


@dataclasses.dataclass(frozen=True)
class ARIMAOrder:
    p: int = 2
    d: int = 1
    q: int = 1


class ARIMA:
    """Stateful wrapper mirroring the paper's usage: fit on the n most recent
    points, forecast the next one.

    ``bank=False`` fits a scalar call as one kernel row instead of a padded
    bank group.  Rows are independent, so its forecasts equal the bank's;
    only the work per call differs.
    """

    def __init__(self, order: ARIMAOrder = ARIMAOrder(), n: int = 60,
                 steps: int = 200, lr: float = 0.05, bank: bool = True,
                 device=None):
        self.order = order
        self.n = n
        self.steps = steps
        self.lr = lr
        self.bank = bank
        self.device = resolve_device(device)

    def _bucket(self, size: int) -> int:
        """Largest history length that fits ``size`` points."""
        buckets = [b for b in (*_BUCKETS, self.n)
                   if b <= min(size, self.n)]
        return buckets[-1]

    def _fit_rows(self, rows: np.ndarray) -> np.ndarray:
        """Forecasts of ``rows [R, n]`` float32 as float64, in one launch."""
        o = self.order
        y = torch.from_numpy(np.ascontiguousarray(rows, np.float32)
                             ).to(self.device)
        fc = arima_bank(y, (o.p, o.d, o.q), self.steps, self.lr)
        return fc.cpu().numpy().astype(np.float64)

    def forecast_next(self, series: np.ndarray) -> float:
        """Forecast the next value of ``series`` (e.g. inter-arrival gaps).

        With ``bank=True`` (the default) the scalar call goes through the
        same padded bank group as :meth:`batched_forecast`, so online and
        batched prediction are bitwise identical."""
        if not self.bank:
            series = np.asarray(series, dtype=np.float32)
            if series.size < 4:
                return float(series[-1]) if series.size else 0.0
            n = self._bucket(series.size)
            y = series[-n:]
            out = float(self._fit_rows(y[None, :])[0])
            return out if np.isfinite(out) else float(np.median(y))
        return float(self.batched_forecast([series])[0])

    def batched_forecast(self, series_list) -> np.ndarray:
        """Forecast the next value of each (ragged) series in one pass.

        Semantics per series are identical to :meth:`forecast_next` — the
        <4-point last-value fallback, history bucketing and the median
        fallback for non-finite fits all apply row-wise — and the returned
        floats are bitwise equal to per-series calls.  Series are grouped by
        bucket into ``BANK_WIDTH``-row groups (short groups padded by
        repeating their first row) and the whole batch is ONE kernel
        launch (:func:`pack_bank`)."""
        if not self.bank:
            return np.array([self.forecast_next(s) for s in series_list],
                            dtype=np.float64)
        out = np.empty(len(series_list), dtype=np.float64)
        by_bucket: dict[int, list[tuple[int, np.ndarray]]] = {}
        for i, series in enumerate(series_list):
            series = np.asarray(series, dtype=np.float32)
            if series.size < 4:
                # not enough history: fall back to the last value
                out[i] = float(series[-1]) if series.size else 0.0
                continue
            n = self._bucket(series.size)
            by_bucket.setdefault(n, []).append((i, series[-n:]))
        if not by_bucket:
            return out
        flat, table = pack_bank({n: [y for _, y in tasks]
                                 for n, tasks in by_bucket.items()})
        o = self.order
        rows = torch.from_numpy(flat).to(self.device)
        fc = arima_bank_segments(rows, table, (o.p, o.d, o.q), self.steps,
                                 self.lr).cpu().numpy().astype(np.float64)
        for row0, _, n in table:
            for j, (i, y) in enumerate(by_bucket[n]):
                v = fc[row0 + j]
                out[i] = v if np.isfinite(v) else float(np.median(y))
        return out


def _gap_stats(g: list[float]) -> tuple[float, float, bool]:
    """(median gap, max gap, fast-path?) for an inter-arrival gap list.

    The gap window is ≤ a couple hundred points and this runs once per
    observed request: plain-Python median/std beat the NumPy dispatch
    overhead by ~20x here.  Shared by the online and batched prediction
    paths so the near-constant-gap decision below is bitwise identical in
    both (a vectorized reimplementation could flip a knife-edge series).

    Near-constant inter-arrivals (scripted cron-style consumers): ARIMA's
    forecast collapses to the median gap; skip the fit.  This is the common
    case for program users and keeps the online engine cheap.
    """
    gs = sorted(g)
    n = len(gs)
    mid = n // 2
    med = gs[mid] if n % 2 else (gs[mid - 1] + gs[mid]) / 2.0
    fast = False
    if med > 0:
        mean = sum(g) / n
        std = (sum((x - mean) ** 2 for x in g) / n) ** 0.5
        fast = std / med < 0.02
    return med, gs[-1], fast


def clamp_forecast_gap(last_ts: float, gap: float, max_gap: float) -> float:
    """Forecast post-processing: clamp the predicted gap to [0, 10·max_gap]
    and advance the last timestamp.  One shared definition for the scalar,
    batched and planner paths — part of the bitwise online==batched
    contract, like :func:`_gap_stats`."""
    return float(last_ts + min(max(gap, 0.0), 10 * max_gap))


def predict_next_timestamp(timestamps: np.ndarray, model: ARIMA | None = None) -> float:
    """Predict ts_{i+1} from past request timestamps (paper §IV-A2): model the
    inter-arrival gap series and add the forecast gap to the last timestamp."""
    timestamps = np.asarray(timestamps, dtype=np.float64)
    if timestamps.size < 2:
        return float(timestamps[-1]) if timestamps.size else 0.0
    gaps = np.diff(timestamps)
    med, max_gap, fast = _gap_stats(gaps.tolist())
    if fast:
        return float(timestamps[-1] + med)
    model = model or ARIMA()
    gap = model.forecast_next(gaps.astype(np.float32))
    return clamp_forecast_gap(float(timestamps[-1]), gap, max_gap)


def predict_next_timestamps(series_list, model: ARIMA | None = None) -> np.ndarray:
    """Batched :func:`predict_next_timestamp` over many timestamp series.

    Fast-path decisions reuse :func:`_gap_stats` and ARIMA-bound series are
    flushed through :meth:`ARIMA.batched_forecast` in one pass, so each
    element is bitwise equal to the scalar call on the same series."""
    model = model or ARIMA()
    out = np.empty(len(series_list), dtype=np.float64)
    pending: list[tuple[int, np.ndarray, float, float]] = []
    for i, ts in enumerate(series_list):
        ts = np.asarray(ts, dtype=np.float64)
        if ts.size < 2:
            out[i] = float(ts[-1]) if ts.size else 0.0
            continue
        gaps = np.diff(ts)
        med, max_gap, fast = _gap_stats(gaps.tolist())
        if fast:
            out[i] = float(ts[-1] + med)
            continue
        pending.append((i, gaps.astype(np.float32), float(ts[-1]), max_gap))
    if pending:
        forecasts = model.batched_forecast([p[1] for p in pending])
        for (i, _, last, max_gap), gap in zip(pending, forecasts):
            out[i] = clamp_forecast_gap(last, float(gap), max_gap)
    return out
