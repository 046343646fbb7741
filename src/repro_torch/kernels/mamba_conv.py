"""The Mamba block's causal depthwise conv with its SiLU (K6), forward and
backward.

Per segment ``x [Bt, S, C]`` with weights ``w [K, C]``, bias ``b [C]`` and
an optional state ``[Bt, K-1, C]`` (the last K-1 inputs of the previous
call; zeros without one)::

    xp = cat(state or zeros, x)                     [Bt, S+K-1, C]
    y[t] = silu(b + sum_i w[i] * xp[t+i]),   new_state = xp[S:]

Two versions of each function live here:

- :func:`causal_conv` and :func:`causal_conv_backward` — the wrappers.
  CUDA tensors launch the hand-written kernels in ``csrc/mamba_conv.cu``
  (built with ``nvcc`` at first use into ``build/kernels/libmamba_conv.so``
  and bound with ``ctypes``): one launch for the forward of every segment
  given (the block's ``xs``, ``B`` and ``C``), two for the backward (the
  per-block partial sums of ``dw``/``db`` into fixed slots, then their
  fixed-order sum).  :func:`route` picks the kernels' loads: a thread's
  chunk of channels as one vector where every segment's width is whole
  16-byte vectors and every tensor starts on a 16-byte boundary, else one
  channel a thread.  CPU and meta tensors take the plain versions.  There
  is no fallback: a CUDA input the kernel does not take raises.
- :func:`causal_conv_plain` — the JAX package's ``_causal_conv`` in eager
  torch ops, each rounded to the input type in its order (the kernel's
  forward gives its bits), and :func:`causal_conv_backward_plain`, the
  gradient in float32 in the kernel's order (its ``dx`` is the kernel's
  bit for bit; ``dw``/``db`` sum over batch and sequence in another order).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import nvcc

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SEGMENTS = 3
VECTOR_BYTES = 16
ROUTES = ("vector", "scalar")

# Kernel launches (never the plain versions' calls): forward calls, and
# backward calls (two CUDA kernels each), and both by route
LAUNCHES = 0
BWD_LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)

_lib = None


def reset_counts() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = 0
    BWD_LAUNCHES = 0
    for k in ROUTES:
        ROUTE_LAUNCHES[k] = 0


def route(widths, dtype, tensors) -> str:
    """``"vector"`` where every segment's width in ``widths`` is whole
    16-byte vectors of ``dtype`` and every tensor given starts on a 16-byte
    boundary, else ``"scalar"`` (one channel a thread)."""
    e = VECTOR_BYTES // dtype.itemsize
    if all(c % e == 0 for c in widths) and all(
            t.data_ptr() % VECTOR_BYTES == 0 for t in tensors
            if t is not None):
        return "vector"
    return "scalar"


def _kind(way: str, dtype) -> int:
    """The launchers' first argument: the dtype, plus 2 for the vector
    route (whose chunk width the kernel source fixes by direction)."""
    return _DTYPES[dtype] + 2 * (way == "vector")


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def causal_conv_plain(x, w, b, state=None):
    """Depthwise causal conv1d with its SiLU.  x: [B,S,C]; w: [K,C]; returns
    (y, new_state) where state is the last K-1 inputs for decode."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)                       # [B,S+K-1,C]
    s = x.shape[1]
    y = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + s, :] * w[i][None, None, :]
    y = y + b[None, None, :]
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return F.silu(y.float()).to(x.dtype), new_state


def _pre(x, w, b):
    """The conv before its SiLU (no state), rounded as the forward."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.cat([torch.zeros((x.shape[0], k - 1, x.shape[2]),
                                dtype=x.dtype, device=x.device), x], dim=1)
    y = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + s, :] * w[i][None, None, :]
    return y + b[None, None, :], xp


def causal_conv_backward_plain(x, w, b, g):
    """Gradients of :func:`causal_conv_plain` without a state, from the
    output's cotangent ``g``: ``(dx, dw, db)`` in the inputs' types.  In
    float32, with pre recomputed::

        dpre = g * s * (1 + pre * (1 - s)),  s = 1 / (1 + exp(-pre))
        dx[t] = sum_i w[i] dpre[t+K-1-i]  (i ascending; dpre = 0 past S)
        dw[i] = sum_{b,t} xp[b,t+i] dpre[b,t],  db = sum_{b,t} dpre[b,t]
    """
    k, s = w.shape[0], x.shape[1]
    pre, xp = _pre(x, w, b)
    p = pre.float()
    sg = 1 / (1 + torch.exp(-p))
    dpre = g.float() * sg * (1 + p * (1 - sg))
    dp = torch.cat([dpre, dpre.new_zeros((dpre.shape[0], k - 1,
                                          dpre.shape[2]))], dim=1)
    wf = w.float()
    dx = wf[0] * dp[:, k - 1:k - 1 + s]
    for i in range(1, k):
        dx = dx + wf[i] * dp[:, k - 1 - i:k - 1 - i + s]
    xpf = xp.float()
    dw = torch.stack([(xpf[:, i:i + s] * dpre).sum((0, 1)) for i in range(k)])
    db = dpre.sum((0, 1))
    return dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


def start_build(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/mamba_conv.cu`` for sm_90a; ``wait()`` on the
    result installs the library and returns the compiler's diagnostics."""
    return nvcc.start("mamba_conv", (), verbose)


def _load():
    global _lib
    if _lib is None:
        lib = nvcc.load("mamba_conv")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.conv_fwd_launch.argtypes = [i] * 5 + [p] * 8
        lib.conv_bwd_launch.argtypes = [i] * 5 + [p] * 9 + [i, p]
        lib.conv_bwd_slot_rows.argtypes = [i] * 5
        for fn in (lib.conv_fwd_launch, lib.conv_bwd_launch,
                   lib.conv_bwd_slot_rows, lib.conv_max_k):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ptrs(ts):
    return (ctypes.c_void_p * MAX_SEGMENTS)(
        *[None if t is None else t.data_ptr() for t in ts])


def _check(xs, ws, bs, more=()) -> tuple[int, int, int]:
    """(Bt, S, K) of the segments; raises on what the kernel does not take."""
    n = len(xs)
    if not 1 <= n <= MAX_SEGMENTS or len(ws) != n or len(bs) != n:
        raise ValueError(f"causal_conv takes 1 to {MAX_SEGMENTS} segments, "
                         f"each with its weight and bias")
    x0 = xs[0]
    if x0.dim() != 3:
        raise ValueError(f"causal_conv takes [Bt, S, C] inputs, got "
                         f"{tuple(x0.shape)}")
    bt, s = x0.shape[:2]
    k = ws[0].shape[0]
    if not 1 <= k <= _load().conv_max_k():
        raise ValueError(f"causal_conv kernel takes K <= "
                         f"{_load().conv_max_k()}, got {k}")
    if x0.dtype not in _DTYPES:
        raise TypeError(f"causal_conv kernel takes float32 or bfloat16, got "
                        f"{x0.dtype}")
    for x, w, b in zip(xs, ws, bs):
        c = x.shape[-1]
        if x.shape != (bt, s, c) or w.shape != (k, c) or b.shape != (c,):
            raise ValueError(f"causal_conv: shapes {tuple(x.shape)}, "
                             f"{tuple(w.shape)}, {tuple(b.shape)} do not "
                             f"make a segment of [{bt}, {s}, C]")
    for t in (*xs, *ws, *bs, *more):
        if t is None:
            continue
        if t.device != x0.device or t.dtype != x0.dtype:
            raise ValueError(f"causal_conv: every tensor on {x0.device} in "
                             f"{x0.dtype}, got {t.device} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("causal_conv needs contiguous tensors")
    return bt, s, k


def causal_conv(xs, ws, bs, states=None, want_state: bool = False):
    """The conv with its SiLU over segments ``xs`` (lists of up to three
    [Bt, S, C_j] tensors with weights ``ws`` [K, C_j] and biases ``bs``
    [C_j]; ``states``: a list of [Bt, K-1, C_j], or None for zeros).
    Returns the outputs and, with ``states`` or ``want_state``, the new
    states (else None), as lists.  CUDA tensors launch the kernel, once for
    all segments; CPU and meta tensors take :func:`causal_conv_plain`
    segment by segment."""
    global LAUNCHES
    dev = xs[0].device
    with_state = states is not None or want_state
    if dev.type in ("cpu", "meta"):
        outs = [causal_conv_plain(x, w, b, None if states is None
                                  else states[j])
                for j, (x, w, b) in enumerate(zip(xs, ws, bs))]
        return ([y for y, _ in outs],
                [st for _, st in outs] if with_state else None)
    if dev.type != "cuda":
        raise ValueError(f"causal_conv: unsupported device {dev}")
    bt, s, k = _check(xs, ws, bs, states or ())
    if states is not None and (len(states) != len(xs) or any(
            st.shape != (bt, k - 1, x.shape[-1])
            for st, x in zip(states, xs))):
        raise ValueError("causal_conv: one [Bt, K-1, C] state a segment")
    lib = _load()
    ys = [torch.empty_like(x) for x in xs]
    new = [torch.empty((bt, k - 1, x.shape[-1]), dtype=x.dtype, device=dev)
           for x in xs] if with_state and k > 1 else None
    widths = [x.shape[-1] for x in xs]
    way = route(widths, xs[0].dtype, [*xs, *ws, *bs, *(states or ()), *ys,
                                      *(new or ())])
    cs = (ctypes.c_int * MAX_SEGMENTS)(*widths)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.conv_fwd_launch(
            _kind(way, xs[0].dtype), len(xs), bt, s, k, _ptrs(xs),
            _ptrs(ws), _ptrs(bs),
            None if states is None else _ptrs(states), _ptrs(ys),
            None if new is None else _ptrs(new), cs, stream)
    nvcc.check_launch("causal_conv", err)
    LAUNCHES += 1
    ROUTE_LAUNCHES[way] += 1
    if with_state and new is None:
        new = [None] * len(xs)
    return ys, new


def causal_conv_backward(xs, ws, bs, gs):
    """Gradients of :func:`causal_conv` without states from the outputs'
    cotangents ``gs``: lists ``(dxs, dws, dbs)``.  CUDA tensors launch the
    kernel (the slots, then their fixed-order sum; two calls give the same
    bits); CPU and meta tensors take :func:`causal_conv_backward_plain`."""
    global BWD_LAUNCHES
    dev = xs[0].device
    if dev.type in ("cpu", "meta"):
        outs = [causal_conv_backward_plain(x, w, b, g)
                for x, w, b, g in zip(xs, ws, bs, gs)]
        return tuple(list(t) for t in zip(*outs))
    if dev.type != "cuda":
        raise ValueError(f"causal_conv_backward: unsupported device {dev}")
    bt, s, k = _check(xs, ws, bs, gs)
    if any(g.shape != x.shape for g, x in zip(gs, xs)):
        raise ValueError("causal_conv_backward: a cotangent of another shape")
    lib = _load()
    widths = [x.shape[-1] for x in xs]
    dxs = [torch.empty_like(x) for x in xs]
    dws = [torch.empty_like(w) for w in ws]
    dbs = [torch.empty_like(b) for b in bs]
    way = route(widths, xs[0].dtype, [*xs, *ws, *bs, *gs, *dxs])
    kind = _kind(way, xs[0].dtype)
    cs = (ctypes.c_int * MAX_SEGMENTS)(*widths)
    with torch.cuda.device(dev):
        rows = lib.conv_bwd_slot_rows(kind, bt, s, k, sum(widths))
        if rows < 1:
            nvcc.check_launch("causal_conv_backward", -rows or 1)
        slots = torch.empty(rows * (k + 1) * sum(widths),
                            dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.conv_bwd_launch(
            kind, len(xs), bt, s, k, _ptrs(xs), _ptrs(ws), _ptrs(bs),
            _ptrs(gs), _ptrs(dxs), _ptrs(dws), _ptrs(dbs), cs,
            slots.data_ptr(), rows, stream)
    nvcc.check_launch("causal_conv_backward", err)
    BWD_LAUNCHES += 1
    ROUTE_LAUNCHES[way] += 1
    return dxs, dws, dbs
