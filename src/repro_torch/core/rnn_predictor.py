"""GRU-based next-request-time predictor — the paper's own stated future
work (§VI: "replacing the ARIMA time-series prediction model with the
portable RNN based predictor [65]").

A small GRU is fit per request stream on the normalized inter-arrival gap
series (same CSS-style objective as the ARIMA fit, same history buckets).
Drop-in replacement for :func:`repro_torch.core.arima.
predict_next_timestamp`.  The fit runs through the GRU fit kernel
(:mod:`repro_torch.kernels.gru_fit`: hand-written CUDA on a CUDA device,
one launch per forecast; its plain PyTorch version on the CPU).

The initial weights are drawn from a ``torch.Generator`` seeded with
``seed``, as the JAX package's ``_init_params`` draws them (normal x 0.3,
zero biases).  PyTorch cannot reproduce ``jax.random``'s numbers, so the
same seed gives other initial weights, and other forecasts, than the JAX
package; pass ``params`` (for example
:func:`repro_torch.convert.gru_params_from_numpy` of the JAX package's
``_init_params``) to start from given weights.  Like ARIMA's, the 150-step
Adam fit amplifies ulps, so forecasts agree across frameworks only to a
tolerance, and only on well-conditioned series.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.gru_fit import LAYOUT, N_PARAMS, gru_fit

_BUCKETS = (4, 8, 16, 32)


def init_params(seed: int) -> torch.Tensor:
    """The flat float32 ``[N_PARAMS]`` initial parameters for ``seed``:
    seven normal draws x 0.3 (``wz, uz, wr, ur, wc, uc, wo``, in that
    order, on the CPU) and zero biases."""
    gen = torch.Generator().manual_seed(seed)
    params = {name: torch.zeros(shape) for name, shape in LAYOUT}
    for name in ("wz", "uz", "wr", "ur", "wc", "uc", "wo"):
        params[name] = torch.randn(params[name].shape, generator=gen) * 0.3
    return torch.cat([params[name].reshape(-1) for name, _ in LAYOUT])


class GRUPredictor:
    """Per-stream GRU gap predictor (drop-in for ARIMA.forecast_next)."""

    def __init__(self, n: int = 60, steps: int = 150, lr: float = 0.03,
                 seed: int = 0, device=None,
                 params: torch.Tensor | None = None):
        self.n = n
        self.steps = steps
        self.lr = lr
        self.device = resolve_device(device)
        p0 = init_params(seed) if params is None else params
        if tuple(p0.shape) != (N_PARAMS,):
            raise ValueError(f"params must be [{N_PARAMS}], got "
                             f"{tuple(p0.shape)}")
        self.params = p0.to(self.device, torch.float32).contiguous()

    def forecast_next(self, series: np.ndarray) -> float:
        series = np.asarray(series, dtype=np.float32)
        if series.size < 4:
            return float(series[-1]) if series.size else 0.0
        buckets = [b for b in (*_BUCKETS, self.n)
                   if b <= min(series.size, self.n)]
        n = buckets[-1]
        y = series[-n:]
        rows = torch.from_numpy(np.ascontiguousarray(y[None, :])
                                ).to(self.device)
        val = float(gru_fit(rows, self.params, self.steps, self.lr)[0])
        if not np.isfinite(val):
            val = float(np.median(y))
        return val


def predict_next_timestamp_rnn(timestamps: np.ndarray,
                               model: GRUPredictor | None = None) -> float:
    """RNN analogue of :func:`repro_torch.core.arima.
    predict_next_timestamp`."""
    timestamps = np.asarray(timestamps, dtype=np.float64)
    if timestamps.size < 2:
        return float(timestamps[-1]) if timestamps.size else 0.0
    gaps = np.diff(timestamps)
    med = float(np.median(gaps))
    if med > 0 and float(np.std(gaps)) / med < 0.02:
        return float(timestamps[-1] + med)
    model = model or GRUPredictor()
    gap = model.forecast_next(gaps.astype(np.float32))
    gap = float(np.clip(gap, 0.0, 10 * np.max(gaps)))
    return float(timestamps[-1] + gap)
