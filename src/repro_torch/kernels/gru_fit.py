"""GRU fit (K4): per row, 150 Adam steps of backpropagation through time
over a 12-unit GRU on the normalised series, then a one-step forecast, for
a ``[rows, n]`` float32 batch.

Three versions of one function live here:

- :func:`gru_fit` — the wrapper.  A CUDA tensor launches the hand-written
  kernel in ``csrc/gru_fit.cu`` (built with ``nvcc`` at first use into
  ``build/kernels/libgru_fit.so`` and bound with ``ctypes``) once for the
  whole batch; a CPU tensor takes the plain version.  There is no fallback
  from one to the other.
- :func:`gru_fit_plain` — eager PyTorch, vectorised over rows, a Python
  loop over time and :func:`gru_grad_manual` for the gradient: the oracle
  the kernel is held against.
- :func:`gru_grad_manual` — the hand-derived reverse recursion through
  time in PyTorch.  The kernel transcribes it; the tests hold it against
  ``torch.autograd`` of :func:`gru_loss`.

Per row, in float32, what the JAX package's ``core/rnn_predictor.py::
_compiled_fit`` computes: normalise (mean, population std, ``sd >=
1e-8``), run ``steps`` Adam steps (lr, betas 0.9/0.999, eps 1e-8, float32
step counter) on the mean of ``(preds[:-1] - y[1:])**2``, where
``preds[t] = wo . h_{t+1} + bo`` and the cell is

    z = sigmoid(Wz h + uz x + bz),  r = sigmoid(Wr h + ur x + br),
    c = tanh(Wc (r * h) + uc x + bc),  h' = (1 - z) * h + z * c,

then forecast ``preds[-1] * sd + mu`` after one last forward pass.  It is
not ``torch.nn.GRU``'s cell (the reset gate multiplies ``h`` before the
product), so no library call computes the function.

Every 12-term sum runs in one fixed pairwise tree (:func:`_rowsum`: four
dependent adds after the products, not eleven), every other sum in the
order written here.  The kernel, built with ``-fmad=false``, does the
same, so on one card it rounds as this module's separate tensor ops do;
its design shortens each GRU step's critical path (``csrc/gru_fit.cu``'s
header).

Parameters are one flat float32 vector of :data:`N_PARAMS` in the order of
:data:`LAYOUT` (:func:`pack` / :func:`unpack`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.arima_bank import _prepare

HIDDEN = 12
# name and shape of each parameter, in the order of the flat vector
LAYOUT = (("wz", (HIDDEN, HIDDEN)), ("wr", (HIDDEN, HIDDEN)),
          ("wc", (HIDDEN, HIDDEN)), ("uz", (HIDDEN,)), ("ur", (HIDDEN,)),
          ("uc", (HIDDEN,)), ("bz", (HIDDEN,)), ("br", (HIDDEN,)),
          ("bc", (HIDDEN,)), ("wo", (HIDDEN,)), ("bo", ()))
N_PARAMS = sum(math.prod(shape) for _, shape in LAYOUT)      # 517
MAX_N = 64

# -fmad=false: no a*b+c contraction, so every operation rounds as the plain
# version's separate tensor ops do (see the note in the source)
NVCC_FLAGS = ("-fmad=false",)

# Kernel launches (never the plain version's calls).
LAUNCHES = 0

_lib = None


def reset_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def unpack(flat: torch.Tensor) -> dict[str, torch.Tensor]:
    """Views of ``flat [R, N_PARAMS]`` as ``{name: [R, *shape]}``."""
    out, k = {}, 0
    for name, shape in LAYOUT:
        size = math.prod(shape)
        out[name] = flat[:, k:k + size].reshape(flat.shape[0], *shape)
        k += size
    return out


def pack(params: dict[str, torch.Tensor]) -> torch.Tensor:
    """``[R, N_PARAMS]`` from ``{name: [R, *shape]}`` (inverse of
    :func:`unpack`)."""
    rows = params["bo"].shape[0]
    return torch.cat([params[name].reshape(rows, -1) for name, _ in LAYOUT],
                     dim=1)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _rowsum(prod: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a multiple of 4 long) in one fixed tree:
    four partial sums ``s_k = p_k + p_{k+4} + p_{k+8} + ...`` taken chunk
    by chunk, then ``(s_0 + s_1) + (s_2 + s_3)``.  For 12 terms that is
    four dependent adds instead of eleven, in the order the kernel's
    ``dot`` adds them."""
    s = prod[..., 0:4]
    for k in range(4, prod.shape[-1], 4):
        s = s + prod[..., k:k + 4]
    return (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])


def _matvec(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``sum_j w[:, i, j] * v[:, j]``, left to right over ``j``."""
    return _rowsum(w * v[:, None, :])


def _matvec_t(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``sum_i w[:, i, j] * a[:, i]``, left to right over ``i``."""
    return _rowsum((w * a[:, :, None]).transpose(1, 2))


def gru_forward(p: dict[str, torch.Tensor], y: torch.Tensor):
    """The GRU over normalised rows ``y [R, n]`` from ``h = 0``.

    Returns ``(preds [R, n], (H [R, n+1, 12], Z, Rg, C [R, n, 12]))``:
    ``preds[:, t]`` predicts ``y[:, t+1]``; ``H[:, t]`` is the state before
    step ``t`` and ``Z``, ``Rg``, ``C`` the gates of step ``t`` (what the
    reverse recursion needs)."""
    rows, n = y.shape
    wzr = torch.cat([p["wz"], p["wr"]], dim=1)              # [R, 24, 12]
    uzr = torch.cat([p["uz"], p["ur"]], dim=1)
    bzr = torch.cat([p["bz"], p["br"]], dim=1)
    h = torch.zeros(rows, HIDDEN, dtype=y.dtype, device=y.device)
    hs, zs, rs, cs = [h], [], [], []
    for t in range(n):
        x = y[:, t:t + 1]
        zr = torch.sigmoid(_matvec(wzr, h) + uzr * x + bzr)
        z, r = zr[:, :HIDDEN], zr[:, HIDDEN:]
        c = torch.tanh(_matvec(p["wc"], r * h) + p["uc"] * x + p["bc"])
        h = (1 - z) * h + z * c
        hs.append(h)
        zs.append(z)
        rs.append(r)
        cs.append(c)
    H = torch.stack(hs, dim=1)
    preds = _rowsum(H[:, 1:] * p["wo"][:, None, :]) + p["bo"][:, None]
    return preds, (H, torch.stack(zs, 1), torch.stack(rs, 1),
                   torch.stack(cs, 1))


def gru_loss(flat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-row loss ``mean((preds[:-1] - y[1:])**2)`` (differentiable)."""
    preds, _ = gru_forward(unpack(flat), y)
    err = preds[:, :-1] - y[:, 1:]
    return (err * err).mean(dim=1)


def gru_grad_manual(flat: torch.Tensor, y: torch.Tensor):
    """``(loss [R], gradient [R, N_PARAMS])`` of :func:`gru_loss` by the
    reverse recursion through time, per row and step ``t = n-1 .. 0``
    (``g_t = 2 e_t / (n-1)`` for ``t < n-1``, else 0; ``gh`` the adjoint of
    the state after step ``t``):

    ``gwo += g_t h_{t+1}``, ``gbo += g_t``, ``gh += g_t wo``;
    ``dz = gh (c - h)``, ``dc = gh z``, ``dh = gh (1 - z)``;
    ``dac = dc (1 - c^2)``, ``daz = dz (z (1 - z))``;
    ``gWc += dac (r h)^T``, ``guc += dac x``, ``gbc += dac``;
    ``drh = Wc^T dac``, ``dr = drh h``, ``dh += drh r``,
    ``dar = dr (r (1 - r))``;
    ``gWz += daz h^T``, ``gWr += dar h^T`` (and their ``u``, ``b``);
    ``dh += Wz^T daz``, ``dh += Wr^T dar``; ``gh = dh``.

    This is the arithmetic the CUDA kernel runs per row, op for op."""
    with torch.no_grad():
        p = unpack(flat)
        rows, n = y.shape
        preds, (H, Z, Rg, C) = gru_forward(p, y)
        err = preds[:, :-1] - y[:, 1:]
        loss = (err * err).mean(dim=1)
        gpred = torch.cat([(2.0 / (n - 1)) * err,
                           torch.zeros_like(err[:, :1])], dim=1)
        g = {name: torch.zeros_like(t) for name, t in p.items()}
        gh = torch.zeros(rows, HIDDEN, dtype=y.dtype, device=y.device)
        for t in reversed(range(n)):
            gp, x = gpred[:, t:t + 1], y[:, t:t + 1]
            g["wo"] = g["wo"] + gp * H[:, t + 1]
            g["bo"] = g["bo"] + gpred[:, t]
            gh = gh + gp * p["wo"]
            h, z, r, c = H[:, t], Z[:, t], Rg[:, t], C[:, t]
            dz = gh * (c - h)
            dc = gh * z
            dh = gh * (1 - z)
            dac = dc * (1 - c * c)
            daz = dz * (z * (1 - z))
            g["wc"] = g["wc"] + dac[:, :, None] * (r * h)[:, None, :]
            g["uc"] = g["uc"] + dac * x
            g["bc"] = g["bc"] + dac
            drh = _matvec_t(p["wc"], dac)
            dr = drh * h
            dh = dh + drh * r
            dar = dr * (r * (1 - r))
            g["wz"] = g["wz"] + daz[:, :, None] * h[:, None, :]
            g["wr"] = g["wr"] + dar[:, :, None] * h[:, None, :]
            g["uz"] = g["uz"] + daz * x
            g["bz"] = g["bz"] + daz
            g["ur"] = g["ur"] + dar * x
            g["br"] = g["br"] + dar
            dh = dh + _matvec_t(p["wz"], daz)
            dh = dh + _matvec_t(p["wr"], dar)
            gh = dh
        return loss, pack(g)


def _check_params(params0: torch.Tensor, y: torch.Tensor) -> None:
    if params0.dtype != torch.float32 or tuple(params0.shape) != (N_PARAMS,):
        raise ValueError(f"gru_fit needs float32 params0 [{N_PARAMS}], got "
                         f"{params0.dtype} {tuple(params0.shape)}")
    if params0.device != y.device:
        raise ValueError(f"params0 on {params0.device}, rows on {y.device}")


def gru_fit_plain(y: torch.Tensor, params0: torch.Tensor, steps: int,
                  lr: float) -> torch.Tensor:
    """Forecast ``[R]`` float32 for raw rows ``y [R, n]`` from the initial
    parameters ``params0 [N_PARAMS]`` (the same for every row): the
    kernel's function in eager PyTorch."""
    _check_params(params0, y)
    # K1's normalisation undifferenced: mean, population std >= 1e-8, sums
    # left to right, as the kernel runs them
    yn, _, mu, sd = _prepare(y, 0)
    params = params0[None, :].expand(y.shape[0], N_PARAMS).contiguous()
    m = torch.zeros_like(params)
    v = torch.zeros_like(params)
    t = torch.zeros((), dtype=torch.float32, device=y.device)
    for _ in range(steps):
        _, g = gru_grad_manual(params, yn)
        t = t + 1
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - torch.pow(0.9, t))
        vh = v / (1 - torch.pow(0.999, t))
        params = params - lr * mh / (torch.sqrt(vh) + 1e-8)
    with torch.no_grad():
        preds, _ = gru_forward(unpack(params), yn)
        return preds[:, -1] * sd + mu


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


def start_build(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/gru_fit.cu`` for sm_90a; ``wait()`` on the
    result installs the library and returns the compiler's diagnostics
    (``-Xptxas -v`` when ``verbose``)."""
    return nvcc.start("gru_fit", NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = nvcc.load("gru_fit", NVCC_FLAGS)
        fn = lib.gru_fit_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def gru_fit(y: torch.Tensor, params0: torch.Tensor, steps: int,
            lr: float) -> torch.Tensor:
    """Fit and forecast every row of ``y [rows, n]`` (float32, contiguous,
    ``2 <= n <= MAX_N``) from ``params0 [N_PARAMS]``.  A CUDA tensor
    launches the kernel once for all rows; a CPU tensor takes the plain
    version.  Rows are independent: a row's result does not depend on the
    launch width or on the other rows."""
    global LAUNCHES
    if y.dtype != torch.float32:
        raise TypeError(f"gru_fit needs float32 rows, got {y.dtype}")
    if y.dim() != 2 or not y.is_contiguous():
        raise ValueError("gru_fit needs a contiguous [rows, n] tensor")
    rows, n = y.shape
    if not 2 <= n <= MAX_N:
        raise ValueError(f"history length n={n} outside [2, {MAX_N}]")
    if steps < 0:
        raise ValueError(f"steps={steps} < 0")
    _check_params(params0, y)
    if y.device.type == "cpu":
        return gru_fit_plain(y, params0, steps, lr)
    if y.device.type != "cuda":
        raise ValueError(f"gru_fit: unsupported device {y.device}")
    out = torch.empty(rows, dtype=torch.float32, device=y.device)
    if rows == 0:
        return out
    p0 = params0.contiguous()
    lib = _load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.gru_fit_launch(y.data_ptr(), p0.data_ptr(), out.data_ptr(),
                                 rows, n, steps, float(lr), stream)
    nvcc.check_launch("gru_fit", err)
    LAUNCHES += 1
    return out
