"""The Mamba layer's one-token decode step (K8): the three causal convs with
their SiLU from the conv states, dt's softplus, the decay, the float32 state
update and the output with its D skip; every state updated in place.

For the projections ``xs [Bt, 1, H*P]``, ``B``/``C [Bt, 1, G*N]`` (shared by
a group's heads) and the raw ``dt [Bt, 1, H]``, the layer's conv weights
``[K, C]`` and biases ``[C]`` (xs, B, C), its conv states ``[Bt, K-1, C]``,
the float32 state ``ssm [Bt, H, N, P]`` and the float32 ``dt_bias``,
``A_log``, ``D`` ``[H]``::

    x, B, C = silu(conv(state, projection))      (each of the three)
    dt = softplus(dt_raw + dt_bias);  dA = exp(dt * -exp(A_log))
    ssm <- ssm * dA + B (dt x);  y = C . ssm + x * D
    state <- [state[1:], projection]

Two versions live here:

- :func:`decode_layer` — the wrapper.  CUDA tensors launch the hand-written
  kernel in ``csrc/mamba_decode.cu`` (built with ``nvcc`` at first use into
  ``build/kernels/libmamba_decode.so`` and bound with ``ctypes``), one
  launch a layer and token, reading each state once and writing it once, in
  place; CPU and meta tensors take the plain version.  There is no
  fallback: a CUDA input the kernel does not take raises.
- :func:`decode_layer_plain` — the JAX package's step in eager torch ops:
  ``causal_conv_plain`` three times and :func:`decode_step_plain`, then the
  new states written over the old ones.  The kernel rounds each op as they
  do (the convs' and the state's bits are theirs) but sums ``y`` over N in
  another, fixed order (two calls give the same bits).

The kernel's group state (the B/C conv state every head of a group reads)
is written by the group's last reader, found by a counter per (row, group)
in a small buffer of zeros that the module keeps per device
(:func:`_counters`); the launch leaves it zero.  A buffer is made on a
device's first call, which must not be inside a CUDA graph capture.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import nvcc
from repro_torch.kernels.mamba_conv import causal_conv_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VECTOR_BYTES = 16
# the smallest counter buffer made (ints): rows x groups of a later call up
# to this size reuse it
_MIN_COUNTERS = 1024

# Kernel launches (never the plain version's calls)
LAUNCHES = 0

_lib = None
# per device index: every counter buffer made, the last the largest (older
# ones stay alive for the graphs that captured them)
_COUNTERS: dict[int, list[torch.Tensor]] = {}


def reset_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def decode_step_plain(xs, ssm, dt_raw, dt_bias, A_log, Bm, Cm, D):
    """The state step after the convs: ``(s_new, y)``, the new float32
    state [Bt, H, N, P] and the output [Bt, H, P] in ``xs``'s type, from
    ``xs`` [Bt, H, P] and ``B``/``C`` [Bt, G, N].  The state's input is
    formed as ``B (dt x)``, the kernel's order."""
    dt = F.softplus(dt_raw.float() + dt_bias)[:, 0]             # [B,H]
    A = -torch.exp(A_log)
    dA = torch.exp(dt * A[None, :])
    rep = xs.shape[1] // Bm.shape[1]
    Bh = torch.repeat_interleave(Bm, rep, dim=1)                # [B,H,N]
    Ch = torch.repeat_interleave(Cm, rep, dim=1)
    dtx = dt[..., None] * xs.float()                            # [B,H,P]
    s_new = ssm * dA[..., None, None] + Bh.float()[..., None] * dtx[:, :,
                                                                    None]
    y = torch.einsum("bhn,bhnp->bhp", Ch, s_new.to(xs.dtype))
    return s_new, y + xs * D[None, :, None].to(xs.dtype)


def _dims(xs, Bm, dt_raw, ssm) -> tuple[int, int, int, int, int]:
    """(Bt, H, G, N, P) of a call."""
    bt, h = xs.shape[0], dt_raw.shape[-1]
    n, p = ssm.shape[2], ssm.shape[3]
    return bt, h, Bm.shape[-1] // n, n, p


def decode_layer_plain(xs, Bm, Cm, dt_raw, ws, bs, states, ssm, dt_bias,
                       A_log, D):
    """One token of the layer's state step; returns ``y`` [Bt, H, P] in
    ``xs``'s type and writes the new conv ``states`` (a list: xs, B, C)
    and ``ssm`` over the old ones."""
    bt, h, g, n, p = _dims(xs, Bm, dt_raw, ssm)
    outs = [causal_conv_plain(t, w, b, st)
            for t, w, b, st in zip((xs, Bm, Cm), ws, bs, states)]
    (x, _), (Bc, _), (Cc, _) = outs
    s_new, y = decode_step_plain(x.reshape(bt, h, p), ssm, dt_raw, dt_bias,
                                 A_log, Bc.reshape(bt, g, n),
                                 Cc.reshape(bt, g, n), D)
    for st, (_, new) in zip(states, outs):
        if new is not None:
            st.copy_(new)
    ssm.copy_(s_new)
    return y


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


def start_build(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/mamba_decode.cu`` for sm_90a; ``wait()`` on
    the result installs the library and returns the compiler's
    diagnostics."""
    return nvcc.start("mamba_decode", (), verbose)


def _load():
    global _lib
    if _lib is None:
        lib = nvcc.load("mamba_decode")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.decode_layer_launch.argtypes = [i] * 7 + [p, p, i, p]
        lib.decode_layer_launch.restype = ctypes.c_int
        lib.decode_layer_takes.argtypes = [i] * 3
        lib.decode_layer_takes.restype = ctypes.c_int
        _lib = lib
    return _lib


def _counters(device: torch.device, need: int) -> torch.Tensor:
    """A buffer of at least ``need`` zero ints on ``device`` for the
    kernel's group counters (each launch leaves them zero)."""
    bufs = _COUNTERS.setdefault(device.index, [])
    if bufs and bufs[-1].numel() >= need:
        return bufs[-1]
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("decode_layer: its first call on a device, or "
                           "one with more rows x groups than before, cannot "
                           "be captured in a CUDA graph; call it once "
                           "eagerly first")
    buf = torch.zeros(max(need, _MIN_COUNTERS), dtype=torch.int32,
                      device=device)
    torch.cuda.current_stream(device).synchronize()
    bufs.append(buf)
    return buf


def _check(xs, Bm, Cm, dt_raw, ws, bs, states, ssm, dt_bias, A_log, D):
    """(Bt, H, G, N, P, K) of a CUDA call; raises on what the kernel does
    not take."""
    if xs.dtype not in _DTYPES:
        raise TypeError(f"decode_layer kernel takes float32 or bfloat16, got "
                        f"{xs.dtype}")
    if xs.dim() != 3 or ssm.dim() != 4 or len(ws) != 3 or len(bs) != 3 or \
            len(states) != 3:
        raise ValueError("decode_layer takes xs [Bt, 1, H*P], ssm [Bt, H, "
                         "N, P] and three conv weights, biases and states")
    bt, h, g, n, p = _dims(xs, Bm, dt_raw, ssm)
    k = ws[0].shape[0]
    if g < 1 or h % g or n * g != Bm.shape[-1]:
        raise ValueError(f"decode_layer: B's {Bm.shape[-1]} channels are no "
                         f"whole groups of N={n} dividing {h} heads")
    if not _load().decode_layer_takes(k, n, p):
        raise ValueError(f"decode_layer kernel takes K=4, N <= 128 and P a "
                         f"multiple of 4, got K={k}, N={n}, P={p}")
    widths = (h * p, g * n, g * n)
    want = {"ssm": (ssm, (bt, h, n, p), torch.float32),
            "dt": (dt_raw, (bt, 1, h), xs.dtype),
            "dt_bias": (dt_bias, (h,), torch.float32),
            "A_log": (A_log, (h,), torch.float32),
            "D": (D, (h,), torch.float32)}
    for j, (name, c) in enumerate(zip("xBC", widths)):
        want[name] = ((xs, Bm, Cm)[j], (bt, 1, c), xs.dtype)
        want[f"w_{name}"] = (ws[j], (k, c), xs.dtype)
        want[f"b_{name}"] = (bs[j], (c,), xs.dtype)
        want[f"state_{name}"] = (states[j], (bt, k - 1, c), xs.dtype)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or \
                t.device != xs.device or not t.is_contiguous():
            raise ValueError(f"decode_layer: {name} must be a contiguous "
                             f"{dtype} {shape} on {xs.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if ssm.data_ptr() % VECTOR_BYTES:
        raise ValueError("decode_layer: ssm must start on a 16-byte "
                         "boundary (the kernel's vectors)")
    return bt, h, g, n, p, k


def decode_layer(xs, Bm, Cm, dt_raw, ws, bs, states, ssm, dt_bias, A_log,
                 D):
    """One token of the layer's state step (as :func:`decode_layer_plain`):
    returns ``y`` [Bt, H, P] and updates ``states`` (xs, B, C) and ``ssm``
    in place.  CUDA tensors launch the kernel; CPU and meta tensors take the
    plain version."""
    global LAUNCHES
    if xs.device.type in ("cpu", "meta"):
        return decode_layer_plain(xs, Bm, Cm, dt_raw, ws, bs, states, ssm,
                                  dt_bias, A_log, D)
    if xs.device.type != "cuda":
        raise ValueError(f"decode_layer: unsupported device {xs.device}")
    bt, h, g, n, p, k = _check(xs, Bm, Cm, dt_raw, ws, bs, states, ssm,
                               dt_bias, A_log, D)
    y = torch.empty((bt, h, p), dtype=xs.dtype, device=xs.device)
    ts = (xs, Bm, Cm, dt_raw, *ws, *bs, *states, ssm, dt_bias, A_log, D, y)
    ptrs = (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    with torch.cuda.device(xs.device):
        counters = _counters(xs.device, bt * g)
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = _load().decode_layer_launch(
            _DTYPES[xs.dtype], bt, h, g, n, p, k, ptrs, counters.data_ptr(),
            counters.numel(), stream)
    nvcc.check_launch("decode_layer", err)
    LAUNCHES += 1
    return y
