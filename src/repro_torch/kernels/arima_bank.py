"""ARIMA bank: per-row CSS fit of an ARMA(p, q) on a d-times differenced
series plus a one-step forecast, for a ``[rows, n]`` float32 batch.

Three versions of one function live here:

- :func:`arima_bank_segments` — the wrapper.  A CUDA tensor launches the
  hand-written kernel in ``csrc/arima_bank.cu`` (built with ``nvcc`` at
  first use into ``build/kernels/libarima_bank.so`` and bound with
  ``ctypes``) once over a table of segments, one per history length (see
  :func:`segment_table`); a CPU tensor takes the plain version.  There is
  no fallback from one to the other.  :func:`arima_bank` is its
  one-segment form for a ``[rows, n]`` batch (the online callers).  The
  kernel runs each segment on the path :func:`route` picks from (order,
  n) alone: registers for (2, 1, 1) at the bank's lengths, local memory
  for the rest; both compute the same floats.
- :func:`arima_fit_plain` — eager PyTorch, vectorised over rows, a Python
  loop over time and ``torch.autograd.grad`` for the gradient: the oracle
  the kernel is held against.
- :func:`css_grad_manual` — the hand-derived reverse recursion of the CSS
  gradient in PyTorch.  The kernel transcribes it; the tests hold it
  against autograd.

Per row, in float32: normalise (mean, population std, ``sd >= 1e-8``),
difference ``d`` times keeping the tails, run ``steps`` Adam steps
(lr, betas 0.9/0.999, eps 1e-8, float32 step counter) on
``sum(mask * e_t**2) / n`` where ``n`` is the undifferenced length and the
mask drops the first ``max(p, q)`` residuals, then forecast one step with
the masked residuals and integrate back through the tails.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import nvcc

MAX_N = 64
MAX_P = 4
MAX_Q = 4
MAX_D = 2

# Rows per kernel block (one warp): segment offsets are multiples of it.
WARP = 32
MAX_SEGMENTS = 16
# History lengths of the register path at order (2, 1, 1): the bank's
# buckets and ARIMA's default history.  The one owner of the set: the build
# passes it to the source as a mask (bit n - 1 per length), which
# instantiates one fit_211<n> per length and lets the launcher refuse any
# other n for the register path.
REGISTER_N = (4, 8, 16, 32, 60)

# -fmad=false: no a*b+c contraction, so every operation rounds as the plain
# version's separate tensor ops do (see the note in the source)
NVCC_FLAGS = ("-fmad=false", "-DARIMA_REGISTER_N_MASK="
              f"{sum(1 << (n - 1) for n in REGISTER_N):#x}ULL")

# Kernel launches and rows fitted by launches (never by the plain version).
LAUNCHES = 0
ROWS = 0

_lib = None


def reset_counts() -> None:
    global LAUNCHES, ROWS
    LAUNCHES = 0
    ROWS = 0


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _prepare(y: torch.Tensor, d: int):
    """Normalise each row and difference it ``d`` times.

    Sums run left to right and divide by a tensor (true division), the
    order the kernel uses, so the two agree bit for bit.
    Returns ``(y_d [R, n-d], tails [d x R], mu [R], sd [R])``."""
    n = y.shape[1]
    n_t = torch.full((), float(n), dtype=y.dtype, device=y.device)
    s = y[:, 0]
    for i in range(1, n):
        s = s + y[:, i]
    mu = s / n_t
    centered = y - mu[:, None]
    ss = centered[:, 0] * centered[:, 0]
    for i in range(1, n):
        ss = ss + centered[:, i] * centered[:, i]
    sd = torch.clamp(torch.sqrt(ss / n_t), min=1e-8)
    yd = centered / sd[:, None]
    tails = []
    for _ in range(d):
        tails.append(yd[:, -1])
        yd = yd[:, 1:] - yd[:, :-1]
    return yd, tails, mu, sd


def css_residuals(params: torch.Tensor, y: torch.Tensor, p: int,
                  q: int) -> torch.Tensor:
    """Unmasked one-step residuals ``e [R, N]`` of the ARMA(p, q) recursion
    ``e_t = y_t - (c + sum_i phi_i y_{t-1-i}) - sum_j theta_j e_{t-1-j}``
    on differenced rows ``y [R, N]`` (lags before the start are zero)."""
    n_rows, n = y.shape
    c = params[:, 0]
    e: list[torch.Tensor] = []
    for t in range(n):
        pred = c
        if p:
            s = None
            for i in range(p):
                if t - 1 - i >= 0:
                    term = params[:, 1 + i] * y[:, t - 1 - i]
                    s = term if s is None else s + term
            if s is not None:
                pred = pred + s
        if q:
            s = None
            for j in range(q):
                if t - 1 - j >= 0:
                    term = params[:, 1 + p + j] * e[t - 1 - j]
                    s = term if s is None else s + term
            if s is not None:
                pred = pred + s
        e.append(y[:, t] - pred)
    return torch.stack(e, dim=1)


def _mask(n_diff: int, p: int, q: int, device) -> torch.Tensor:
    return torch.arange(n_diff, device=device) >= max(p, q)


def css_loss(params: torch.Tensor, y: torch.Tensor, p: int, q: int,
             n: int) -> torch.Tensor:
    """Per-row CSS loss ``sum(mask * e**2) / n``."""
    e = css_residuals(params, y, p, q)
    r = torch.where(_mask(y.shape[1], p, q, y.device), e,
                    torch.zeros((), dtype=e.dtype, device=e.device))
    return (r * r).sum(dim=1) / n


def css_grad_manual(params: torch.Tensor, y: torch.Tensor, p: int, q: int,
                    n: int) -> torch.Tensor:
    """Gradient of :func:`css_loss` by the reverse recursion

    ``abar_t = (2/n) mask_t e_t - sum_j theta_j abar_{t+1+j}``,
    ``dc = -sum_t abar_t``, ``dphi_i = -sum_t abar_t y_{t-1-i}``,
    ``dtheta_j = -sum_t abar_t e_{t-1-j}``,

    with the unmasked residuals ``e`` (the recursion feeds on them).  This
    is the arithmetic the CUDA kernel runs per row."""
    with torch.no_grad():
        e = css_residuals(params, y, p, q)
        n_rows, n_diff = y.shape
        warm = max(p, q)
        abar: list[torch.Tensor | None] = [None] * n_diff
        g = [torch.zeros(n_rows, dtype=y.dtype, device=y.device)
             for _ in range(1 + p + q)]
        for t in reversed(range(n_diff)):
            a = (2.0 / n) * e[:, t] if t >= warm else torch.zeros_like(e[:, t])
            # later lags first: the order autograd accumulates them in
            for j in reversed(range(q)):
                if t + 1 + j < n_diff:
                    a = a - params[:, 1 + p + j] * abar[t + 1 + j]
            abar[t] = a
            g[0] = g[0] - a
            for i in range(p):
                if t - 1 - i >= 0:
                    g[1 + i] = g[1 + i] - a * y[:, t - 1 - i]
            for j in range(q):
                if t - 1 - j >= 0:
                    g[1 + p + j] = g[1 + p + j] - a * e[:, t - 1 - j]
        return torch.stack(g, dim=1)


def arima_fit_plain(y: torch.Tensor, order, steps: int, lr: float
                    ) -> torch.Tensor:
    """Forecast ``[R]`` float32 for raw rows ``y [R, n]``: the kernel's
    function in eager PyTorch with an autograd gradient."""
    p, d, q = (int(v) for v in order)
    n = y.shape[1]
    yd, tails, mu, sd = _prepare(y, d)
    params = torch.zeros(y.shape[0], 1 + p + q, dtype=torch.float32,
                         device=y.device)
    m = torch.zeros_like(params)
    v = torch.zeros_like(params)
    t = torch.zeros((), dtype=torch.float32, device=y.device)
    for _ in range(steps):
        w = params.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(css_loss(w, yd, p, q, n).sum(), w)
        t = t + 1
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - torch.pow(0.9, t))
        vh = v / (1 - torch.pow(0.999, t))
        params = params - lr * mh / (torch.sqrt(vh) + 1e-8)
    with torch.no_grad():
        e = css_residuals(params, yd, p, q)
        n_diff = yd.shape[1]
        warm = max(p, q)
        fy = params[:, 0]
        if p:
            s = params[:, 1] * yd[:, n_diff - 1]
            for i in range(1, p):
                s = s + params[:, 1 + i] * yd[:, n_diff - 1 - i]
            fy = fy + s
        if q:
            s = None
            for j in range(q):
                r = e[:, n_diff - 1 - j] if n_diff - 1 - j >= warm \
                    else torch.zeros_like(fy)
                term = params[:, 1 + p + j] * r
                s = term if s is None else s + term
            fy = fy + s
        for tail in reversed(tails):
            fy = tail + fy
        return fy * sd + mu


# ---------------------------------------------------------------------------
# segments and paths
# ---------------------------------------------------------------------------


def route(order, n: int) -> str:
    """The kernel path for rows of history length ``n`` at ``order``:
    ``"register"`` (the series, residuals and adjoint in registers, time
    loops unrolled) for the order every caller uses, (2, 1, 1), at the
    bank's history lengths :data:`REGISTER_N`; ``"generic"`` (local-memory
    arrays, any order and length the wrapper takes) for everything else.
    Both compute the same floats."""
    p, d, q = (int(v) for v in order)
    return "register" if (p, d, q) == (2, 1, 1) and n in REGISTER_N \
        else "generic"


def segment_table(sizes: dict[int, int]) -> list[tuple[int, int, int]]:
    """``(row offset, rows, n)`` per history length ``n`` with
    ``sizes[n]`` rows: segments back to back, longest ``n`` first, so the
    longest chains start first.  Every segment but the last must hold whole
    warps of :data:`WARP` rows (see :func:`check_segments`)."""
    table, row = [], 0
    for n in sorted(sizes, reverse=True):
        table.append((row, int(sizes[n]), int(n)))
        row += int(sizes[n])
    check_segments(table)
    return table


def check_segments(table) -> None:
    """Raise unless ``table`` covers rows ``0..total`` exactly once, in
    order, with every segment starting on a :data:`WARP`-row boundary: the
    kernel runs one warp per block, so a warp must never mix two ``n``."""
    if not 1 <= len(table) <= MAX_SEGMENTS:
        raise ValueError(f"{len(table)} segments outside 1..{MAX_SEGMENTS}")
    row = 0
    for row0, rows, n in table:
        if row0 != row or rows < 1:
            raise ValueError(f"segment ({row0}, {rows}, {n}) does not start "
                             f"at row {row} or is empty")
        if row0 % WARP:
            raise ValueError(f"segment ({row0}, {rows}, {n}) starts inside a "
                             f"warp of {WARP} rows: one warp would mix two "
                             f"history lengths")
        row += rows


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


def start_build(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/arima_bank.cu`` for sm_90a; ``wait()`` on the
    result installs the library and returns the compiler's diagnostics
    (``-Xptxas -v`` when ``verbose``)."""
    return nvcc.start("arima_bank", NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = nvcc.load("arima_bank", NVCC_FLAGS)
        fn = lib.arima_bank_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def refined_mismatches(pairs: int, seed: int, device) -> tuple[int, int]:
    """Hold the register path's branch-free division and square root
    against the IEEE operations on the card: ``pairs`` random operand pairs
    inside the division's range and every float inside the square root's.
    Returns the (division, square root) mismatches; both are 0 for the
    register path to round as the plain version does."""
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    lib = _load()
    fn = lib.arima_bank_refined_mismatches
    fn.argtypes = [ctypes.c_ulonglong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(counts.device):
        err = fn(seed, pairs, counts.data_ptr(),
                 torch.cuda.current_stream(counts.device).cuda_stream)
    nvcc.check_launch("arima_bank_refined_mismatches", err)
    div_bad, sqrt_bad = counts.tolist()
    return div_bad, sqrt_bad


def _check_order(p: int, d: int, q: int, n: int, steps: int) -> None:
    if not (0 <= p <= MAX_P and 0 <= q <= MAX_Q and 0 <= d <= MAX_D):
        raise ValueError(f"order (p={p}, d={d}, q={q}) outside p,q <= "
                         f"{MAX_P}, d <= {MAX_D}")
    if not (1 <= n <= MAX_N) or n - d < max(p, q, 1):
        raise ValueError(f"history length n={n} outside [max(p, q, 1) + d, "
                         f"{MAX_N}]")
    if steps < 0:
        raise ValueError(f"steps={steps} < 0")


def arima_bank_segments(y: torch.Tensor, table, order, steps: int,
                        lr: float) -> torch.Tensor:
    """Fit and forecast every row of a segmented batch in one launch.

    ``y`` is a contiguous 1-D float32 tensor holding the segments of
    ``table`` (``(row offset, rows, n)`` entries, see
    :func:`segment_table`) back to back, each ``rows x n`` row-major.
    Returns the ``[total rows]`` forecasts.  A CUDA tensor launches the
    kernel once, each segment on the path :func:`route` gives it; a CPU
    tensor takes the plain version per segment."""
    global LAUNCHES, ROWS
    p, d, q = (int(v) for v in order)
    if y.dtype != torch.float32:
        raise TypeError(f"arima_bank needs float32 rows, got {y.dtype}")
    if y.dim() != 1 or not y.is_contiguous():
        raise ValueError("arima_bank_segments needs a contiguous 1-D tensor")
    check_segments(table)
    for _, _, n in table:
        _check_order(p, d, q, n, steps)
    if y.numel() != sum(rows * n for _, rows, n in table):
        raise ValueError(f"{y.numel()} floats for segments of "
                         f"{sum(rows * n for _, rows, n in table)}")
    if y.device.type == "cpu":
        parts, elem = [], 0
        for _, rows, n in table:
            parts.append(arima_fit_plain(y[elem:elem + rows * n].view(rows, n),
                                         (p, d, q), steps, lr))
            elem += rows * n
        return torch.cat(parts)
    if y.device.type != "cuda":
        raise ValueError(f"arima_bank: unsupported device {y.device}")
    total = sum(rows for _, rows, _ in table)
    out = torch.empty(total, dtype=torch.float32, device=y.device)
    flat = [v for row0, rows, n in table
            for v in (row0, rows, n, int(route((p, d, q), n) == "register"))]
    cells = (ctypes.c_int * len(flat))(*flat)
    lib = _load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.arima_bank_launch(y.data_ptr(), out.data_ptr(), cells,
                                    len(table), p, d, q, steps, float(lr),
                                    stream)
    nvcc.check_launch("arima_bank", err)
    LAUNCHES += 1
    ROWS += total
    return out


def arima_bank(y: torch.Tensor, order, steps: int, lr: float
               ) -> torch.Tensor:
    """Fit and forecast every row of ``y [rows, n]`` (float32, contiguous)
    in one launch: one segment of :func:`arima_bank_segments`.

    Rows are independent: a row's result does not depend on the launch
    width or on the other rows."""
    if y.dtype != torch.float32:
        raise TypeError(f"arima_bank needs float32 rows, got {y.dtype}")
    if y.dim() != 2 or not y.is_contiguous():
        raise ValueError("arima_bank needs a contiguous [rows, n] tensor")
    rows, n = y.shape
    if rows == 0:
        _check_order(*(int(v) for v in order), n, steps)
        return torch.empty(0, dtype=torch.float32, device=y.device)
    return arima_bank_segments(y.view(-1), [(0, rows, n)], order, steps, lr)
