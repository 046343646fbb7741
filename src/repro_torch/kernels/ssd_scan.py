"""Mamba-2 SSD chunked scan (K3): ``y`` and the final state of the SSM
recurrence for ``x [Bt,S,H,P]``, ``dt [Bt,S,H]``, ``A [H]`` and ``B``/``C``
``[Bt,S,G,N]``.

Two versions of one function live here:

- :func:`ssd_scan` — the wrapper.  A CUDA tensor launches the hand-written
  kernel in ``csrc/ssd_scan.cu`` (built with ``nvcc`` at first use into
  ``build/kernels/libssd_scan.so`` and bound with ``ctypes``); a CPU tensor
  takes the plain version.  There is no fallback from one to the other: a
  CUDA input the kernel does not take raises.
- :func:`ssd_scan_plain` — the exact per-token recurrence
  (:func:`repro_torch.kernels.ref.ssd_ref`) in eager PyTorch: the oracle
  the kernel is held against.

Both return ``(y [Bt,S,H,P]`` in ``x``'s type, ``final_state [Bt,H,N,P]``
float32), as the JAX package's Pallas kernel
(``kernels/ssd_scan.py::_ssd_kernel``) does.  The CUDA kernel works in
chunks of its own (:func:`inner_chunk`, by input type) whatever the
model's chunk (chunking is exact) and takes any ``S >= 1``.  One wrapper
call runs three CUDA kernels (chunk states, the serial state walk, the
output) over a scratch the wrapper allocates (:func:`scratch_bytes`);
bfloat16 inputs take the tensor cores, float32 inputs float32 FMAs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import ssd_ref

STATE_DIMS = (64, 128)     # N
HEAD_DIMS = (64, 128)      # P
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches (never the plain version's calls).
LAUNCHES = 0

_lib = None


def reset_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def inner_chunk(dtype: torch.dtype) -> int:
    """Positions per chunk of the kernel on ``dtype`` inputs, as the built
    library states it (the kernel alone decides it)."""
    return _load().ssd_scan_inner_chunk(_DTYPES[dtype])


def n_chunks(s: int, dtype: torch.dtype) -> int:
    return -(-s // inner_chunk(dtype))


def scratch_bytes(bt: int, s: int, h: int, n: int, p: int,
                  dtype: torch.dtype) -> int:
    """Bytes of the kernel's float32 scratch for one call on ``dtype``
    inputs: the chunk states ``[Bt, chunks, H, N, P]`` and the chunk
    decays ``[Bt, chunks, H]``."""
    return bt * n_chunks(s, dtype) * h * (n * p + 1) * 4


def ssd_scan_plain(x, dt, A, B, C):
    y, state = ssd_ref(x, dt, A, B, C)
    return y.to(x.dtype), state


def start_build(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/ssd_scan.cu`` for sm_90a; ``wait()`` on the
    result installs the library and returns the compiler's diagnostics
    (``-Xptxas -v`` when ``verbose``)."""
    return nvcc.start("ssd_scan", verbose=verbose)


def _load():
    global _lib
    if _lib is None:
        lib = nvcc.load("ssd_scan")
        fn = lib.ssd_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_inner_chunk.argtypes = [ctypes.c_int]
        lib.ssd_scan_inner_chunk.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, dt, A, B, C) -> None:
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan needs float32 or bfloat16 x/B/C of one "
                        f"type, got {x.dtype}/{B.dtype}/{C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("ssd_scan needs float32 dt and A")
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError("ssd_scan needs x [Bt,S,H,P], B/C [Bt,S,G,N]")
    bt, s, h, p = x.shape
    if tuple(dt.shape) != (bt, s, h) or tuple(A.shape) != (h,) \
            or tuple(B.shape[:2]) != (bt, s):
        raise ValueError(f"ssd_scan shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}")
    g, n = B.shape[2], B.shape[3]
    if h % g:
        raise ValueError(f"H={h} is not a multiple of G={g}")
    if n not in STATE_DIMS or p not in HEAD_DIMS:
        raise ValueError(f"ssd_scan kernel takes N in {STATE_DIMS} and P in "
                         f"{HEAD_DIMS}, got N={n}, P={p}")
    if not all(t.is_contiguous() for t in (x, dt, A, B, C)):
        raise ValueError("ssd_scan needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan needs 16-byte aligned x, B, C")


def ssd_scan(x, dt, A, B, C):
    """SSD scan; returns ``(y, final_state)``."""
    global LAUNCHES
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    _check(x, dt, A, B, C)
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((bt, h, n, p), dtype=torch.float32, device=x.device)
    lib = _load()
    nc = n_chunks(s, x.dtype)
    states = torch.empty((bt, nc, h, n, p), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((bt, nc, h), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), states.data_ptr(),
            decay.data_ptr(), bt, s, h, g, n, p,
            _DTYPES[x.dtype], nc, stream)
    nvcc.check_launch("ssd_scan", err)
    LAUNCHES += 1
    return y, state
