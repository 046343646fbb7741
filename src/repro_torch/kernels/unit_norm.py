"""The unit's residual add and RMSNorm (K9), forward and backward.

Over rows of width ``W`` (d_model), with the stream ``x`` and the pending
branch output ``h`` (the previous mixer's or FFN's; None: none)::

    s = x + h                                   (rounded to x's type)
    y = (float(s) * rsqrt(mean(float(s)^2) + eps)) * scale     -> x's type

The float32 ``scale`` stays float32.  The forward also returns each row's
float32 ``r = rsqrt(...)``, which the backward takes with the saved ``s``.
From the norm's cotangent ``dy`` and the stream's own ``ds`` (None: none)
the backward gives ``d`` (the gradient of both ``x`` and ``h``) and
``dscale``::

    n = s r;  a = dy * scale
    d = ds + T(r (a - n mean(a n)))             (rounded as autograd adds)
    dscale = sum_rows dy n

Two versions of each function live here:

- :func:`add_rmsnorm` and :func:`add_rmsnorm_backward` — the wrappers.
  CUDA tensors launch the hand-written kernels in ``csrc/unit_norm.cu``
  (built with ``nvcc`` at first use into ``build/kernels/libunit_norm.so``
  and bound with ``ctypes``): the forward one launch, the backward two (the
  rows' gradients with per-block sums of ``dscale``, then their fixed-order
  sum; two calls give the same bits).  :func:`route` picks the kernels'
  loads: 16-byte vectors where every row is whole vectors and every tensor
  starts on a 16-byte boundary, else element by element.  CPU and meta
  tensors take the plain versions.  There is no fallback: a CUDA input the
  kernels do not take raises.
- :func:`add_rmsnorm_plain` — the add and the JAX package's ``rmsnorm``
  (``src/repro/models/layers.py:44``) in eager torch ops, exactly the ops
  the model ran before the add moved into the next norm, and
  :func:`add_rmsnorm_backward_plain`, the gradient in float32 in the
  kernel's order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import nvcc

EPS = 1e-6
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VECTOR_BYTES = 16                     # a thread's chunk of a row
MAX_CHUNKS = 2048                     # chunks a row at most (UN_MAX_CHUNKS)
ROUTES = ("vector", "scalar")

# Kernel launches (never the plain versions' calls): forward calls and
# backward calls, and both by route
LAUNCHES = 0
BWD_LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)

_lib = None
# the backward's blocks by (device, dtype, route, with ds, rows, width)
_BLOCKS: dict[tuple, int] = {}


def reset_counts() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = 0
    BWD_LAUNCHES = 0
    for k in ROUTES:
        ROUTE_LAUNCHES[k] = 0


def chunk(dtype) -> int:
    """Elements of ``dtype`` in a thread's 16-byte chunk."""
    return VECTOR_BYTES // dtype.itemsize


def max_width(dtype) -> int:
    """The widest row the kernels take."""
    return MAX_CHUNKS * chunk(dtype)


def route(w: int, dtype, tensors) -> str:
    """``"vector"`` where a row of ``w`` is whole 16-byte chunks of
    ``dtype`` and every tensor given starts on a 16-byte boundary (one
    vector load or store a chunk), else ``"scalar"`` (the same chunks,
    element by element)."""
    if w % chunk(dtype) == 0 and all(t.data_ptr() % VECTOR_BYTES == 0
                                     for t in tensors if t is not None):
        return "vector"
    return "scalar"


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def rmsnorm_plain(x, scale, eps: float = EPS):
    """The JAX package's ``rmsnorm``: float32 mean of squares, rsqrt,
    the scale, back to ``x``'s type."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(dtype)


def add_rmsnorm_plain(x, h, scale, eps: float = EPS):
    """``(s, y)``: ``s = x + h`` (``x`` itself without ``h``) and its norm
    :func:`rmsnorm_plain`."""
    s = x if h is None else x + h
    return s, rmsnorm_plain(s, scale, eps)


def rstd_plain(s, eps: float = EPS):
    """The forward's ``rsqrt(mean(s^2) + eps)`` per row, float32 [..., 1]."""
    sf = s.float()
    return torch.rsqrt(torch.mean(sf * sf, dim=-1, keepdim=True) + eps)


def add_rmsnorm_backward_plain(dy, ds, s, scale, rstd=None,
                               eps: float = EPS):
    """Gradients of :func:`add_rmsnorm_plain` from the norm's cotangent
    ``dy`` and the stream's ``ds`` (None: none): ``(d, dscale)``, ``d`` in
    ``s``'s type (the gradient of both ``x`` and ``h``), ``dscale``
    float32.  In float32, with ``r`` the forward's rstd (recomputed when
    not given)::

        n = s r;  a = dy scale;  dot = sum_row a n
        d = ds + T(r (a - n dot / W));  dscale = sum_rows dy n
    """
    w = s.shape[-1]
    r = rstd_plain(s, eps) if rstd is None else rstd
    r = r.reshape(*s.shape[:-1], 1)
    n = s.float() * r
    dyf = dy.float()
    a = dyf * scale
    dot = torch.sum(a * n, dim=-1, keepdim=True)
    d = (r * (a - n * (dot / w))).to(s.dtype)
    if ds is not None:
        d = ds + d
    dscale = (dyf * n).sum(tuple(range(s.dim() - 1)))
    return d, dscale


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


def start_build(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/unit_norm.cu`` for sm_90a; ``wait()`` on the
    result installs the library and returns the compiler's diagnostics."""
    return nvcc.start("unit_norm", (), verbose)


def _load():
    global _lib
    if _lib is None:
        lib = nvcc.load("unit_norm")
        i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        lib.un_fwd_launch.argtypes = [i] * 4 + [f] + [p] * 7
        lib.un_bwd_blocks.argtypes = [i] * 5
        lib.un_bwd_launch.argtypes = [i] * 4 + [p] * 7 + [i, p, p]
        for fn in (lib.un_fwd_launch, lib.un_bwd_blocks, lib.un_bwd_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, scale, more=()) -> tuple[int, int]:
    """(rows, W); raises on what the kernels do not take."""
    w = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"unit_norm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    for t in more:
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype):
            raise ValueError(f"unit_norm: {tuple(t.shape)} {t.dtype} beside "
                             f"{tuple(x.shape)} {x.dtype}")
    if scale.shape != (w,) or scale.dtype != torch.float32:
        raise ValueError("unit_norm: scale must be float32 [W]")
    for t in (x, scale, *more):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"unit_norm: a tensor on {t.device}, not "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError("unit_norm needs contiguous tensors")
    if w > max_width(x.dtype):
        raise ValueError(f"unit_norm kernel takes rows of at most "
                         f"{max_width(x.dtype)} {x.dtype} elements, got {w}")
    if x.numel() == 0:
        raise ValueError("unit_norm: no rows")
    return x.numel() // w, w


def _ptr(t):
    return None if t is None else t.data_ptr()


def add_rmsnorm(x, h, scale, eps: float = EPS):
    """The add and the norm (as :func:`add_rmsnorm_plain`); returns ``(s, y,
    rstd)``, ``s`` the given ``x`` without ``h``, rstd the rows' float32
    ``rsqrt(var + eps)`` [..., 1] that :func:`add_rmsnorm_backward` takes
    (None on the CPU).  CUDA tensors launch the kernel; CPU and meta
    tensors take the plain version."""
    global LAUNCHES
    if x.device.type in ("cpu", "meta"):
        return (*add_rmsnorm_plain(x, h, scale, eps), None)
    if x.device.type != "cuda":
        raise ValueError(f"add_rmsnorm: unsupported device {x.device}")
    rows, w = _check(x, scale, (h,))
    lib = _load()
    s = x if h is None else torch.empty_like(x)
    y = torch.empty_like(x)
    rstd = torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                       device=x.device)
    way = route(w, x.dtype, (x, h, scale, s, y))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        nvcc.check_launch("add_rmsnorm", lib.un_fwd_launch(
            _DTYPES[x.dtype], way == "vector", rows, w, eps, _ptr(x),
            _ptr(h), _ptr(scale), None if h is None else _ptr(s), _ptr(y),
            _ptr(rstd), stream))
    LAUNCHES += 1
    ROUTE_LAUNCHES[way] += 1
    return s, y, rstd


def _blocks(lib, dtype, vector: bool, ds: bool, rows: int, w: int,
            device) -> int:
    """The backward's blocks (one wave of the card), asked once per shape
    and device: a launch inside a graph capture then asks nothing."""
    key = (device.index, dtype, vector, ds, rows, w)
    if key not in _BLOCKS:
        n = lib.un_bwd_blocks(_DTYPES[dtype], vector, ds, rows, w)
        if n < 1:
            nvcc.check_launch("add_rmsnorm_backward", -n or 1)
        _BLOCKS[key] = n
    return _BLOCKS[key]


def add_rmsnorm_backward(dy, ds, s, scale, rstd):
    """Gradients (as :func:`add_rmsnorm_backward_plain`): ``(d, dscale)``.
    CUDA tensors launch the kernel with the forward's ``rstd``; the sums
    over rows run in a fixed order, so two calls give the same bits.  CPU
    and meta tensors take the plain version."""
    global BWD_LAUNCHES
    if s.device.type in ("cpu", "meta"):
        return add_rmsnorm_backward_plain(dy, ds, s, scale, rstd)
    if s.device.type != "cuda":
        raise ValueError(f"add_rmsnorm_backward: unsupported device "
                         f"{s.device}")
    rows, w = _check(s, scale, (dy, ds))
    if rstd is None or rstd.numel() != rows or rstd.dtype != torch.float32 \
            or not rstd.is_contiguous():
        raise ValueError("add_rmsnorm_backward needs the forward's rstd")
    lib = _load()
    d = torch.empty_like(s)
    dscale = torch.empty_like(scale)
    way = route(w, s.dtype, (dy, ds, s, scale, d))
    with torch.cuda.device(s.device):
        blocks = _blocks(lib, s.dtype, way == "vector", ds is not None,
                         rows, w, s.device)
        slots = torch.empty(blocks * w, dtype=torch.float32,
                            device=s.device)
        stream = torch.cuda.current_stream(s.device).cuda_stream
        nvcc.check_launch("add_rmsnorm_backward", lib.un_bwd_launch(
            _DTYPES[s.dtype], way == "vector", rows, w, _ptr(dy), _ptr(ds),
            _ptr(s), _ptr(scale), _ptr(rstd), _ptr(d), _ptr(slots), blocks,
            _ptr(dscale), stream))
    BWD_LAUNCHES += 1
    ROUTE_LAUNCHES[way] += 1
    return d, dscale
