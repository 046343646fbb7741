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
bfloat16 inputs take the tensor cores, float32 inputs float32 FMAs.  That
is the chunked route, at the N and P of :data:`STATE_DIMS` and
:data:`HEAD_DIMS`; :func:`route` names it, or for any other N and P whose
float32 state fits in a block's shared memory the generic route: one CUDA
kernel running the exact per-token recurrence, no scratch.  The launcher
takes exactly the route named.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import ssd_ref

# N and P of the chunked route.  The one owner of the sets: the build passes
# them to the source as masks (bit d / 64 - 1 per dim), which instantiate
# the chunked kernels at these (N, P) and let the launcher refuse the route
# at any other.
STATE_DIMS = (64, 128)     # N
HEAD_DIMS = (64, 128)      # P
# shared memory a block may use on the H100 (227 KB): the generic route's
# float32 state, B_t, C_t and x_t must fit (:func:`generic_smem_bytes`)
MAX_BLOCK_SMEM = 232_448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("chunked", "generic")          # index = the launcher's route code


def _mask(dims) -> str:
    return f"{sum(1 << (d // 64 - 1) for d in dims):#x}u"


NVCC_FLAGS = (f"-DSSD_FAST_N_MASK={_mask(STATE_DIMS)}",
              f"-DSSD_FAST_P_MASK={_mask(HEAD_DIMS)}")

# Kernel launches (never the plain version's calls), in all and by route.
LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)

_lib = None


def reset_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    ROUTE_LAUNCHES.update(dict.fromkeys(ROUTES, 0))


def generic_smem_bytes(n: int, p: int) -> int:
    """Shared memory of the generic route: the state [N, P], B_t, C_t and
    x_t in float32."""
    return 4 * (n * p + 2 * n + p)


def route(n: int, p: int, dtype: torch.dtype) -> str:
    """The kernel's route for state dim ``n``, head dim ``p`` and input
    type ``dtype``: ``"chunked"`` at :data:`STATE_DIMS` x
    :data:`HEAD_DIMS`, ``"generic"`` for any other ``n, p >= 1`` whose state
    fits in a block's shared memory.  Raises for a shape or type outside
    every route."""
    if dtype not in _DTYPES:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    if n in STATE_DIMS and p in HEAD_DIMS:
        return "chunked"
    if n >= 1 and p >= 1 and generic_smem_bytes(n, p) <= MAX_BLOCK_SMEM:
        return "generic"
    raise ValueError(f"ssd_scan kernel takes N, P >= 1 with a float32 state "
                     f"of at most {MAX_BLOCK_SMEM} bytes of shared memory, "
                     f"got N={n}, P={p}")


def inner_chunk(dtype: torch.dtype) -> int:
    """Positions per chunk of the kernel on ``dtype`` inputs, as the built
    library states it (the kernel alone decides it)."""
    return _load().ssd_scan_inner_chunk(_DTYPES[dtype])


def n_chunks(s: int, dtype: torch.dtype) -> int:
    return -(-s // inner_chunk(dtype))


def scratch_bytes(bt: int, s: int, h: int, n: int, p: int,
                  dtype: torch.dtype) -> int:
    """Bytes of the kernel's float32 scratch for one call on ``dtype``
    inputs: on the chunked route the chunk states ``[Bt, chunks, H, N, P]``
    and the chunk decays ``[Bt, chunks, H]``; the generic route has none."""
    if route(n, p, dtype) == "generic":
        return 0
    return bt * n_chunks(s, dtype) * h * (n * p + 1) * 4


def ssd_scan_plain(x, dt, A, B, C):
    y, state = ssd_ref(x, dt, A, B, C)
    return y.to(x.dtype), state


def start_build(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/ssd_scan.cu`` for sm_90a; ``wait()`` on the
    result installs the library and returns the compiler's diagnostics
    (``-Xptxas -v`` when ``verbose``)."""
    return nvcc.start("ssd_scan", NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = nvcc.load("ssd_scan", NVCC_FLAGS)
        fn = lib.ssd_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_inner_chunk.argtypes = [ctypes.c_int]
        lib.ssd_scan_inner_chunk.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, dt, A, B, C) -> str:
    """Raise on what the kernel does not take; return the route."""
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
    path = route(n, p, x.dtype)
    if not all(t.is_contiguous() for t in (x, dt, A, B, C)):
        raise ValueError("ssd_scan needs contiguous inputs")
    if path == "chunked" and any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan needs 16-byte aligned x, B, C")
    return path


def ssd_scan(x, dt, A, B, C):
    """SSD scan; returns ``(y, final_state)``."""
    global LAUNCHES
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    path = _check(x, dt, A, B, C)
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((bt, h, n, p), dtype=torch.float32, device=x.device)
    lib = _load()
    nc, states, decay = 0, None, None
    if path == "chunked":
        nc = n_chunks(s, x.dtype)
        states = torch.empty((bt, nc, h, n, p), dtype=torch.float32,
                             device=x.device)
        decay = torch.empty((bt, nc, h), dtype=torch.float32,
                            device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(),
            None if states is None else states.data_ptr(),
            None if decay is None else decay.data_ptr(), bt, s, h, g, n, p,
            _DTYPES[x.dtype], nc, ROUTES.index(path), stream)
    nvcc.check_launch("ssd_scan", err)
    LAUNCHES += 1
    ROUTE_LAUNCHES[path] += 1
    return y, state
