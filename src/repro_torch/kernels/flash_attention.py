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
NVCC_FLAGS = ("-DFLASH_FAST_D32_MASK="
              f"{sum(1 << (d // 32 - 1) for d in HEAD_DIMS):#x}u",)

# Kernel launches (never the plain version's calls), in all and by route.
LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)

_lib = None


def reset_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    ROUTE_LAUNCHES.update(dict.fromkeys(ROUTES, 0))


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


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, hkv, hq // hkv, d).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1).to(v.dtype).float()
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def start_build(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/flash_attention.cu`` for sm_90a; ``wait()``
    on the result installs the library and returns the compiler's
    diagnostics (``-Xptxas -v`` when ``verbose``)."""
    return nvcc.start("flash_attention", NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = nvcc.load("flash_attention", NVCC_FLAGS)
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
                    scale: float | None = None) -> torch.Tensor:
    """Causal GQA attention of ``q`` over ``k``/``v``; returns ``[B,S,Hq,D]``
    in ``q``'s type."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    path = _check(q, k, v, causal)
    b, s, hq, d = q.shape
    if window is not None and window < 1:
        raise ValueError(f"window={window} < 1")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            hq, k.shape[2], d, 0 if window is None else int(window),
            float(scale), _DTYPES[q.dtype], ROUTES.index(path), stream)
    nvcc.check_launch("flash_attention", err)
    LAUNCHES += 1
    ROUTE_LAUNCHES[path] += 1
    return out
