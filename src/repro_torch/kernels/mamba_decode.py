"""The Mamba decode's state step (K8): one token's dt, decay, state update
and output with its D skip, per layer.

For ``xs [Bt, H, P]`` (after the conv), the float32 state ``ssm [Bt, H, N,
P]``, the raw ``dt`` projection ``[Bt, 1, H]``, ``B``/``C`` ``[Bt, G, N]``
(shared by a group's heads) and the layer's ``dt_bias``, ``A_log``, ``D``
``[H]`` (float32)::

    dt = softplus(dt_raw + dt_bias);  dA = exp(dt * -exp(A_log))
    s_new = ssm * dA + B (dt x);  y = C . s_new + x * D

Two versions live here:

- :func:`decode_step` — the wrapper.  CUDA tensors launch the hand-written
  kernel in ``csrc/mamba_decode.cu`` (built with ``nvcc`` at first use into
  ``build/kernels/libmamba_decode.so`` and bound with ``ctypes``), one
  launch a layer and token, reading the state once and writing the new one
  once; CPU and meta tensors take the plain version.  There is no
  fallback: a CUDA input the kernel does not take raises.
- :func:`decode_step_plain` — the JAX package's step in eager torch ops.
  The kernel rounds each elementwise op as it does, but forms the state's
  input ``B dt x`` as ``B (dt x)``, where ``torch.einsum`` picks its own
  order of the three factors (one rounding apart), and sums ``y`` over N in
  another order (the kernel's is fixed: two calls give the same bits).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import nvcc

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches (never the plain version's calls)
LAUNCHES = 0

_lib = None


def reset_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def decode_step_plain(xs, ssm, dt_raw, dt_bias, A_log, Bm, Cm, D):
    """``(s_new, y)``: the new float32 state [Bt, H, N, P] and the output
    [Bt, H, P] in ``xs``'s type."""
    dt = F.softplus(dt_raw.float() + dt_bias)[:, 0]             # [B,H]
    A = -torch.exp(A_log)
    dA = torch.exp(dt * A[None, :])
    rep = xs.shape[1] // Bm.shape[1]
    Bh = torch.repeat_interleave(Bm, rep, dim=1)                # [B,H,N]
    Ch = torch.repeat_interleave(Cm, rep, dim=1)
    s_new = (ssm * dA[..., None, None]
             + torch.einsum("bhn,bh,bhp->bhnp", Bh.float(), dt, xs.float()))
    y = torch.einsum("bhn,bhnp->bhp", Ch, s_new.to(xs.dtype))
    return s_new, y + xs * D[None, :, None].to(xs.dtype)


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
        lib.decode_step_launch.argtypes = [i] * 6 + [p] * 11
        lib.decode_step_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def decode_step(xs, ssm, dt_raw, dt_bias, A_log, Bm, Cm, D):
    """One token's state step (as :func:`decode_step_plain`); returns
    ``(s_new, y)``.  CUDA tensors launch the kernel; CPU and meta tensors
    take the plain version."""
    global LAUNCHES
    if xs.device.type in ("cpu", "meta"):
        return decode_step_plain(xs, ssm, dt_raw, dt_bias, A_log, Bm, Cm, D)
    if xs.device.type != "cuda":
        raise ValueError(f"decode_step: unsupported device {xs.device}")
    if xs.dtype not in _DTYPES:
        raise TypeError(f"decode_step kernel takes float32 or bfloat16, got "
                        f"{xs.dtype}")
    bt, h, p = xs.shape
    g, n = Bm.shape[1:]
    want = {"ssm": (ssm, (bt, h, n, p), torch.float32),
            "dt": (dt_raw, (bt, 1, h), xs.dtype),
            "dt_bias": (dt_bias, (h,), torch.float32),
            "A_log": (A_log, (h,), torch.float32),
            "B": (Bm, (bt, g, n), xs.dtype), "C": (Cm, (bt, g, n), xs.dtype),
            "D": (D, (h,), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or \
                t.device != xs.device or not t.is_contiguous():
            raise ValueError(f"decode_step: {name} must be a contiguous "
                             f"{dtype} {shape} on {xs.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if h % g or not xs.is_contiguous():
        raise ValueError("decode_step: heads must divide into the groups, "
                         "xs contiguous")
    s_new = torch.empty_like(ssm)
    y = torch.empty_like(xs)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = _load().decode_step_launch(
            _DTYPES[xs.dtype], bt, h, g, n, p, xs.data_ptr(),
            ssm.data_ptr(), dt_raw.data_ptr(), dt_bias.data_ptr(),
            A_log.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
            s_new.data_ptr(), y.data_ptr(), stream)
    nvcc.check_launch("decode_step", err)
    LAUNCHES += 1
    return s_new, y
