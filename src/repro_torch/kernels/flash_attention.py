"""Causal GQA flash attention (K2): ``q [B,S,Hq,D]`` against ``k``/``v``
``[B,S,Hkv,D]``, optional sliding window.

Two versions of one function live here:

- :func:`flash_attention` — the wrapper.  A CUDA tensor launches the
  hand-written kernel in ``csrc/flash_attention.cu`` (built with ``nvcc``
  at first use into ``build/kernels/libflash_attention.so`` and bound with
  ``ctypes``); a CPU tensor takes the plain version.  There is no fallback
  from one to the other: a CUDA input the kernel does not take raises.
- :func:`flash_attention_plain` — the same function in eager PyTorch with
  the whole score matrix: the oracle the kernel is held against.

Both compute what the JAX package's Pallas kernel
(``kernels/flash_attention.py::_flash_kernel``) computes: logits in
float32 scaled by ``scale`` (``1/sqrt(D)`` by default), masked to
``k_pos <= q_pos`` and ``q_pos - k_pos < window`` with ``-1e30``, softmax
in float32 with the probabilities rounded to ``v``'s type before the
product with ``v``, output in ``q``'s type.  Unlike the Pallas kernel the
CUDA one takes any ``S >= 1``.  :func:`route` names its route from the head
dim and the input type, and the launcher takes exactly that one: at the
fast head dims :data:`HEAD_DIMS`, bfloat16 runs on the tensor cores
(``wgmma`` fed by TMA) and float32 on float32 FMAs (TF32 cannot meet
float32's tolerance); paligemma-3b's 256 is one of them.  Any other head
dim up to :data:`MAX_HEAD_DIM` (the reduced configs' 8-20, whose bf16 rows
TMA cannot take) takes the generic route, float32 FMAs over the head dim
padded in the kernel.

K2's backward lives here too (``csrc/flash_attention_bwd.cu``, its own
library ``build/kernels/libflash_attention_bwd.so``):
:func:`flash_attention_backward` takes the forward's output and its per-row
log-sum-exp L (``flash_attention(..., return_lse=True)``, float32 [B, Hq,
S]) with the output's cotangent and returns ``dq, dk, dv`` in the inputs'
type: three kernels a call (the row dots Δ = rowsum(dO∘O), then dK/dV per
tile of keys, then dQ per tile of rows), no atomics, so two calls give the
same bits.  :func:`backward_route` names its route: ``"wgmma"`` (bfloat16
on ``wgmma`` at :data:`BWD_WGMMA_HEAD_DIMS`, P and dS kept in registers),
``"mma"`` (bfloat16 on ``mma.sync`` at :data:`BWD_MMA_HEAD_DIMS`) or
``"generic"`` (float32 FMAs, any other D up to 256 and every float32
input).
:func:`flash_attention_backward_plain` is the same gradient in eager
float32 PyTorch, the oracle the kernel is held against.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import nvcc

NEG_INF = -1e30
# Head dims of the fast routes (fma for float32, wgmma for bfloat16).  The
# one owner of the set: the build passes it to the source as a mask (bit
# D / 32 - 1 per head dim), which instantiates the fast kernels at these D
# and lets the launcher refuse the fast routes at any other.
HEAD_DIMS = (64, 128, 160, 256)
MAX_HEAD_DIM = 256          # the generic route's widest head dim
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("fma", "wgmma", "generic")     # index = the launcher's route code
# Head dims of the backward's tensor-core routes, bfloat16 on wgmma and on
# mma.sync; the build passes each set as a mask in the same way.  A wgmma
# dK/dV thread keeps dK and dV, 64 columns a product, beside S^T or dP^T:
# 128 + 32 float32 at D = 128, but 192 + 32 at 160 and 256 + 32 at 256,
# past what a thread can hold (ptxas spills 1,672 bytes at 256:
# scripts/k2_bwd_wide_ptxas.py), so those two stay on mma.sync (243
# registers at 256, no spill).  chip_smoke.py's phase 7 fails on any spill
# of either route.
BWD_WGMMA_HEAD_DIMS = (64, 128)
BWD_MMA_HEAD_DIMS = (160, 256)
# index = the launcher's route code
BWD_ROUTES = ("mma", "generic", "wgmma")


def _d32_mask(dims) -> str:
    return f"{sum(1 << (d // 32 - 1) for d in dims):#x}u"


NVCC_FLAGS = (f"-DFLASH_FAST_D32_MASK={_d32_mask(HEAD_DIMS)}",)
BWD_NVCC_FLAGS = (
    f"-DFLASH_BWD_MMA_D32_MASK={_d32_mask(BWD_MMA_HEAD_DIMS)}",
    f"-DFLASH_BWD_WGMMA_D32_MASK={_d32_mask(BWD_WGMMA_HEAD_DIMS)}")

# Kernel launches (never the plain version's calls), in all and by route;
# the backward's calls (three CUDA kernels each) likewise.
LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
BWD_LAUNCHES = 0
BWD_ROUTE_LAUNCHES = dict.fromkeys(BWD_ROUTES, 0)

_lib = None
_bwd_lib = None


def reset_counts() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = BWD_LAUNCHES = 0
    ROUTE_LAUNCHES.update(dict.fromkeys(ROUTES, 0))
    BWD_ROUTE_LAUNCHES.update(dict.fromkeys(BWD_ROUTES, 0))


def route(d: int, dtype: torch.dtype) -> str:
    """The kernel's route for head dim ``d`` and input type ``dtype``:
    ``"wgmma"`` (bfloat16) or ``"fma"`` (float32) at :data:`HEAD_DIMS`,
    ``"generic"`` for any other ``1 <= d <= MAX_HEAD_DIM``.  Raises for a
    shape or type outside every route."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    if d in HEAD_DIMS:
        return "wgmma" if dtype == torch.bfloat16 else "fma"
    if 1 <= d <= MAX_HEAD_DIM:
        return "generic"
    raise ValueError(f"flash_attention kernel takes head dim 1..{MAX_HEAD_DIM}"
                     f", got {d}")


def backward_route(d: int, dtype: torch.dtype) -> str:
    """The backward kernel's route for head dim ``d`` and input type
    ``dtype``: ``"wgmma"`` (bfloat16 at :data:`BWD_WGMMA_HEAD_DIMS`),
    ``"mma"`` (bfloat16 at :data:`BWD_MMA_HEAD_DIMS`), ``"generic"`` for
    any other ``1 <= d <= MAX_HEAD_DIM`` and every float32 input.  Raises
    for a shape or type outside all three."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention backward takes float32 or bfloat16,"
                        f" got {dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention backward takes head dim "
                         f"1..{MAX_HEAD_DIM}, got {d}")
    if dtype == torch.bfloat16 and d in BWD_WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype == torch.bfloat16 and d in BWD_MMA_HEAD_DIMS:
        return "mma"
    return "generic"


def _live(s: int, causal: bool, window: int | None, device) -> torch.Tensor:
    """[S, S] mask of the (query, key) pairs attention reads."""
    pos = torch.arange(s, device=device)
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    return mask


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """float32; float64 for float64 inputs, which serve only the tests'
    ``gradcheck`` of ``ops.FlashAttention`` on the CPU (no model reaches
    the plain versions with float64)."""
    return torch.promote_types(x.dtype, torch.float32)


def _scaled_logits(q, k, causal, window, scale):
    """Masked logits [B, Hkv, G, S, S] in the work type, and the scale."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    w = _work_dtype(q)
    qg = q.reshape(b, s, hkv, hq // hkv, d).to(w)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(w)) * scale
    logits = torch.where(_live(s, causal, window, q.device), logits,
                         torch.full_like(logits, NEG_INF))
    return logits, scale


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          scale: float | None = None,
                          return_lse: bool = False):
    """The kernel's function in eager PyTorch; with ``return_lse`` also
    each row's log-sum-exp of its masked, scaled logits, float32 [B, Hq,
    S] (float64 for float64 inputs, a type only the tests' gradcheck
    uses)."""
    b, s, hq, d = q.shape
    logits, _ = _scaled_logits(q, k, causal, window, scale)
    p = torch.softmax(logits, dim=-1).to(v.dtype).to(logits.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(logits.dtype))
    out = out.reshape(b, s, hq, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(b, hq, s)


def flash_attention_backward_plain(q, k, v, o, lse, do, *,
                                   causal: bool = True,
                                   window: int | None = None,
                                   scale: float | None = None):
    """``dq, dk, dv`` of causal GQA attention in eager float32 (float64
    for float64 inputs, which only the tests' gradcheck passes), from the
    forward's output ``o``, its log-sum-exp ``lse`` [B, Hq, S] and the
    output's cotangent ``do``: P = exp(scale · q·kᵀ − L) over the live
    pairs, dV = Pᵀ·dO, dP = dO·Vᵀ, Δ = rowsum(dO∘O), dS = P∘(dP − Δ),
    dQ = scale · dS·K, dK = scale · dSᵀ·Q, dK and dV summed over each kv
    head's G query heads; each in its input's type."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    logits, scale = _scaled_logits(q, k, causal, window, scale)
    w = logits.dtype
    live = _live(s, causal, window, q.device)
    lse = lse.to(w).reshape(b, hkv, g, s)[..., None]
    p = torch.where(live, torch.exp(logits - lse), torch.zeros_like(logits))
    dog = do.reshape(b, s, hkv, g, d).to(w)
    og = o.reshape(b, s, hkv, g, d).to(w)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.to(w))
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(w)) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds,
                      q.reshape(b, s, hkv, g, d).to(w)) * scale
    return (dq.reshape(b, s, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def start_build(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/flash_attention.cu`` for sm_90a; ``wait()``
    on the result installs the library and returns the compiler's
    diagnostics (``-Xptxas -v`` when ``verbose``)."""
    return nvcc.start("flash_attention", NVCC_FLAGS, verbose)


def start_build_backward(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/flash_attention_bwd.cu`` (as
    :func:`start_build`)."""
    return nvcc.start("flash_attention_bwd", BWD_NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = nvcc.load("flash_attention", NVCC_FLAGS)
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _load_bwd():
    global _bwd_lib
    if _bwd_lib is None:
        lib = nvcc.load("flash_attention_bwd", BWD_NVCC_FLAGS)
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


def _check(q, k, v, causal: bool) -> str:
    """Raise on what the kernel does not take; return the route."""
    if not causal:
        raise ValueError("flash_attention kernel is causal only")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention needs float32 or bfloat16 q/k/v of "
                        f"one type, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash_attention needs q [B,S,Hq,D], k/v [B,S,Hkv,D]")
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch, length or head dim")
    if hq % k.shape[2]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[2]}")
    path = route(d, q.dtype)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if path == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q, k, v")
    return path


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    scale: float | None = None, return_lse: bool = False):
    """Causal GQA attention of ``q`` over ``k``/``v``; returns ``[B,S,Hq,D]``
    in ``q``'s type, and with ``return_lse`` also each row's log-sum-exp
    (float32 [B, Hq, S]) for the backward."""
    global LAUNCHES
    if q.device.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    path = _check(q, k, v, causal)
    b, s, hq, d = q.shape
    if window is not None and window < 1:
        raise ValueError(f"window={window} < 1")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, hq, k.shape[2], d,
            0 if window is None else int(window), float(scale),
            _DTYPES[q.dtype], ROUTES.index(path), stream)
    nvcc.check_launch("flash_attention", err)
    LAUNCHES += 1
    ROUTE_LAUNCHES[path] += 1
    return (out, lse) if return_lse else out


def _check_backward(q, k, v, o, lse, do, causal: bool) -> str:
    """Raise on what the backward kernel does not take; return the
    route."""
    if not causal:
        raise ValueError("flash_attention backward is causal only")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention backward needs q [B,S,Hq,D], "
                         "k/v [B,S,Hkv,D]")
    if k.shape[-1] != v.shape[-1]:
        raise ValueError(f"flash_attention backward needs Dk == Dv, got "
                         f"{k.shape[-1]} and {v.shape[-1]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, o,
                                                                  do)):
        raise TypeError(f"flash_attention backward needs float32 or bfloat16"
                        f" q/k/v/o/do of one type, got "
                        f"{[t.dtype for t in (q, k, v, o, do)]}")
    b, s, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or \
            k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be q's shape {tuple(q.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, s):
        raise ValueError(f"lse must be float32 {(b, hq, s)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    path = backward_route(d, q.dtype)
    ts = (q, k, v, o, lse, do)
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_attention backward needs its inputs on one "
                         "device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention backward needs contiguous inputs")
    if path != "generic" and any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash_attention backward needs 16-byte aligned "
                         "q, k, v, do")
    return path


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int | None = None,
                             scale: float | None = None):
    """``dq, dk, dv`` of causal GQA attention, from the forward's output
    ``o`` and log-sum-exp ``lse`` and the output's cotangent ``do``, in the
    inputs' type.  A CUDA input launches the backward kernel on the route
    :func:`backward_route` names, or raises; a CPU or meta input takes the
    plain version."""
    global BWD_LAUNCHES
    if q.device.type in ("cpu", "meta"):
        return flash_attention_backward_plain(q, k, v, o, lse, do,
                                              causal=causal, window=window,
                                              scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention backward: unsupported device "
                         f"{q.device}")
    path = _check_backward(q, k, v, o, lse, do, causal)
    if window is not None and window < 1:
        raise ValueError(f"window={window} < 1")
    b, s, hq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    delta = torch.empty_like(lse)           # Δ, the only scratch
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lib = _load_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, s, hq, k.shape[2], d,
            0 if window is None else int(window), float(scale),
            _DTYPES[q.dtype], BWD_ROUTES.index(path), stream)
    nvcc.check_launch("flash_attention backward", err)
    BWD_LAUNCHES += 1
    BWD_ROUTE_LAUNCHES[path] += 1
    return dq, dk, dv
