"""The Mamba block's D skip and gated RMSNorm (K7), forward and backward.

Over rows of width ``W`` (d_inner, or a mesh rank's share of it) with
``P`` channels a head::

    u = y + xs * D[head]                 (no ``D``: u = y)
    v = u * silu(z)
    out = v * rsqrt(sum(v^2) / width + eps) * scale

``width`` is the whole row's: where a mesh splits the row over ranks, the
row's sum of squares is this rank's share all-reduced over ``group`` (the
mesh's ``model`` ranks) between the kernel's two passes, and so is the
backward's row dot.  Nothing gathers the row.

Two versions of each function live here:

- :func:`gated_norm` and :func:`gated_norm_backward` — the wrappers.  CUDA
  tensors launch the hand-written kernels in ``csrc/gated_norm.cu`` (built
  with ``nvcc`` at first use into ``build/kernels/libgated_norm.so`` and
  bound with ``ctypes``): the forward one launch (two around the
  all-reduce with a group), the backward two (three with a group): the
  rows' gradients with per-cluster sums of ``dscale`` and ``dD``, then
  their fixed-order sum.  :func:`route` picks the kernels' loads: 16-byte
  vectors where every row is whole vectors and every tensor starts on a
  16-byte boundary, else element by element.  CPU and meta tensors take
  the plain versions.  There is no fallback: a CUDA input the kernel does
  not take raises.
- :func:`gated_norm_plain` — the JAX package's skip and ``_gated_norm`` in
  eager torch ops (each rounded to the input type in its order; the sum of
  squares is torch's), and :func:`gated_norm_backward_plain`, the gradient
  in float32 in the kernel's order.  Both split at the same points as the
  kernel with a group.
"""
from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import nvcc

EPS = 1e-6
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FUSED, SUM, FINISH = 0, 1, 2          # the kernels' modes
VECTOR_BYTES = 16                     # a thread's chunk of a row
MAX_CHUNKS = 2048                     # chunks a row at most (GN_MAX_CHUNKS)
ROUTES = ("vector", "scalar")

# Kernel launches (never the plain versions' calls): forward calls and
# backward calls, and both by route
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


def _all_reduce(t, group):
    """``t`` summed over ``group``'s ranks, in place (a meta tensor, the
    dry run's, has no values to sum)."""
    if group is not None and t.device.type != "meta":
        dist.all_reduce(t, group=group)
    return t


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _skip(y, xs, D):
    """``y + xs * D[head]`` over [..., H * P] (heads split out, as the JAX
    package broadcasts D, so autograd sums D's gradient as it does)."""
    if D is None:
        return y
    h = D.shape[0]
    return (y.unflatten(-1, (h, -1))
            + xs.unflatten(-1, (h, -1)) * D[:, None].to(xs.dtype)).flatten(-2)


def gated_norm_plain(y, xs, z, D, scale, eps: float = EPS, group=None,
                     width: int | None = None):
    """The skip and the gated norm over the last dimension of ``y``, ``xs``,
    ``z`` ([..., W]; ``D`` [W / P] or None, ``scale`` [W]).  With ``group``
    the row's sum of squares is all-reduced over it (differentiably:
    ``torch.distributed.nn``'s all-reduce) and divided by ``width``."""
    y = _skip(y, xs, D)
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    if group is None:
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
    else:
        from torch.distributed.nn.functional import all_reduce
        ss = torch.sum(yf * yf, dim=-1, keepdim=True)
        if ss.device.type != "meta":
            ss = all_reduce(ss, group=group)
        var = ss / width
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _gate(y, xs, z, D):
    """u, z, s = sigmoid(z), g = silu(z) and v in float32 (of values rounded
    as the forward rounds them)."""
    u = _skip(y, xs, D)
    zf = z.float()
    e = torch.exp(-zf)
    g = (zf / (1 + e)).to(y.dtype)
    v = (u * g).float()
    return u.float(), zf, 1 / (1 + e), g.float(), v


def rstd_plain(y, xs, z, D, eps: float = EPS, group=None,
               width: int | None = None):
    """The forward's ``rsqrt(sum(v^2) / width + eps)`` per row, float32
    [..., 1], its sum split at ``group`` as the kernel's."""
    v = _gate(y, xs, z, D)[4]
    ss = _all_reduce(torch.sum(v * v, dim=-1, keepdim=True), group)
    return torch.rsqrt(ss / (width or y.shape[-1]) + eps)


def gated_norm_backward_plain(dout, y, xs, z, D, scale, rstd=None,
                              eps: float = EPS, group=None,
                              width: int | None = None):
    """Gradients of :func:`gated_norm_plain` (with ``D``) from ``dout``:
    ``(dy, dxs, dz, dD, dscale)``; dy, dxs, dz in the inputs' type, dD and
    dscale float32.  In float32, with ``r`` the forward's rstd (recomputed
    when not given)::

        a = dout * scale;  dot = sum_row a v   (all-reduced over group)
        dv = a r - v (dot r^3 / width);  du = dv g
        dz = dv u s (1 + z (1 - s));  dy = du;  dxs = du D[head]
        dscale = sum_rows dout (v r);  dD[h] = sum_{rows, p} du xs
    """
    width = width or y.shape[-1]
    u, zf, s, g, v = _gate(y, xs, z, D)
    r = rstd_plain(y, xs, z, D, eps, group, width) if rstd is None else rstd
    r = r.reshape(*v.shape[:-1], 1)
    do = dout.float()
    a = do * scale
    dot = _all_reduce(torch.sum(a * v, dim=-1, keepdim=True), group)
    coef = dot * r * r * r / width
    dv = a * r - v * coef
    du = dv * g
    dz = dv * u * s * (1 + zf * (1 - s))
    p = y.shape[-1] // D.shape[0]
    dxs = du * D.to(y.dtype).float().repeat_interleave(p)
    rows = tuple(range(y.dim() - 1))
    dscale = (do * (v * r)).sum(rows)
    dD = (du * xs.float()).sum(rows).reshape(D.shape[0], p).sum(-1)
    return (du.to(y.dtype), dxs.to(y.dtype), dz.to(z.dtype), dD, dscale)


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


def start_build(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/gated_norm.cu`` for sm_90a; ``wait()`` on the
    result installs the library and returns the compiler's diagnostics."""
    return nvcc.start("gated_norm", (), verbose)


def _load():
    global _lib
    if _lib is None:
        lib = nvcc.load("gated_norm")
        i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        lib.gn_fwd_launch.argtypes = [i] * 6 + [f, f] + [p] * 9
        lib.gn_bwd_launch.argtypes = [i] * 6 + [f] + [p] * 12 + [i] \
            + [p] * 3
        lib.gn_bwd_clusters.argtypes = [i] * 4
        for fn in (lib.gn_fwd_launch, lib.gn_bwd_launch,
                   lib.gn_bwd_clusters):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(y, xs, z, D, scale, more=()) -> tuple[int, int, int]:
    """(rows, W, P); raises on what the kernel does not take."""
    w = z.shape[-1]
    if z.dtype not in _DTYPES:
        raise TypeError(f"gated_norm kernel takes float32 or bfloat16, got "
                        f"{z.dtype}")
    for t in (y, xs, *more):
        if t is not None and (t.shape != z.shape or t.dtype != z.dtype):
            raise ValueError(f"gated_norm: {tuple(t.shape)} {t.dtype} beside "
                             f"z's {tuple(z.shape)} {z.dtype}")
    if scale.shape != (w,) or scale.dtype != torch.float32:
        raise ValueError("gated_norm: scale must be float32 [W]")
    p = w
    if D is not None:
        if D.dim() != 1 or w % D.shape[0] or D.dtype != torch.float32:
            raise ValueError(f"gated_norm: D must be float32 [H] with H "
                             f"dividing {w}")
        p = w // D.shape[0]
    for t in (y, xs, z, D, scale, *more):
        if t is None:
            continue
        if t.device != z.device:
            raise ValueError(f"gated_norm: a tensor on {t.device}, not "
                             f"{z.device}")
        if not t.is_contiguous():
            raise ValueError("gated_norm needs contiguous tensors")
    if w > max_width(z.dtype):
        raise ValueError(f"gated_norm kernel takes rows of at most "
                         f"{max_width(z.dtype)} {z.dtype} elements, got {w}")
    return z.numel() // w, w, p


def _ptr(t):
    return None if t is None else t.data_ptr()


def gated_norm(y, xs, z, D, scale, eps: float = EPS, group=None,
               width: int | None = None):
    """The skip and gated norm (as :func:`gated_norm_plain`); returns
    ``(out, rstd)``, rstd the rows' float32 ``rsqrt(var + eps)`` [..., 1]
    that :func:`gated_norm_backward` takes (None on the CPU).  CUDA tensors
    launch the kernel (with ``group``: the rows' sums of squares, their
    all-reduce, the rest); CPU and meta tensors take the plain version."""
    global LAUNCHES
    if z.device.type in ("cpu", "meta"):
        return gated_norm_plain(y, xs, z, D, scale, eps, group, width), None
    if z.device.type != "cuda":
        raise ValueError(f"gated_norm: unsupported device {z.device}")
    rows, w, p = _check(y, xs, z, D, scale)
    lib = _load()
    out = torch.empty_like(z)
    rstd = torch.empty((*z.shape[:-1], 1), dtype=torch.float32,
                       device=z.device)
    ss = None if group is None else torch.empty_like(rstd)
    dt = _DTYPES[z.dtype]
    way = route(w, z.dtype, (y, xs, z, scale, out))
    args = (_ptr(y), _ptr(xs), _ptr(z), _ptr(D), _ptr(scale), _ptr(out),
            _ptr(rstd), _ptr(ss))
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        for mode in ((FUSED,) if group is None else (SUM, FINISH)):
            if mode == FINISH:
                _all_reduce(ss, group)
            nvcc.check_launch("gated_norm", lib.gn_fwd_launch(
                dt, way == "vector", mode, rows, w, p, float(width or w),
                eps, *args, stream))
    LAUNCHES += 1
    ROUTE_LAUNCHES[way] += 1
    return out, rstd


def gated_norm_backward(dout, y, xs, z, D, scale, rstd, group=None,
                        width: int | None = None):
    """Gradients (as :func:`gated_norm_backward_plain`): ``(dy, dxs, dz, dD,
    dscale)``.  CUDA tensors launch the kernel with the forward's ``rstd``
    (with ``group``: the rows' dots, their all-reduce, the rest); the sums
    over rows run in a fixed order, so two calls give the same bits.  CPU
    and meta tensors take the plain version."""
    global BWD_LAUNCHES
    if z.device.type in ("cpu", "meta"):
        return gated_norm_backward_plain(dout, y, xs, z, D, scale, rstd,
                                         group=group, width=width)
    if z.device.type != "cuda":
        raise ValueError(f"gated_norm_backward: unsupported device "
                         f"{z.device}")
    if D is None or xs is None:
        raise ValueError("gated_norm_backward takes the D skip's xs and D")
    rows, w, p = _check(y, xs, z, D, scale, (dout,))
    if rstd is None or rstd.numel() != rows or rstd.dtype != torch.float32 \
            or not rstd.is_contiguous():
        raise ValueError("gated_norm_backward needs the forward's rstd")
    lib = _load()
    dy, dxs, dz = (torch.empty_like(z) for _ in range(3))
    dD = torch.empty_like(D)
    dscale = torch.empty_like(scale)
    dt = _DTYPES[z.dtype]
    way = route(w, z.dtype, (dout, y, xs, z, scale, dy, dxs, dz))
    with torch.cuda.device(z.device):
        clusters = lib.gn_bwd_clusters(dt, way == "vector", rows, w)
        if clusters < 1:
            nvcc.check_launch("gated_norm_backward", -clusters or 1)
        slots = torch.empty(2 * clusters * w, dtype=torch.float32,
                            device=z.device)
        dot = None if group is None else torch.empty_like(rstd)
        args = (_ptr(y), _ptr(xs), _ptr(z), _ptr(D), _ptr(scale),
                _ptr(dout), _ptr(rstd), _ptr(dot), _ptr(dy), _ptr(dxs),
                _ptr(dz), _ptr(slots), clusters, _ptr(dscale), _ptr(dD))
        stream = torch.cuda.current_stream(z.device).cuda_stream
        for mode in ((FUSED,) if group is None else (SUM, FINISH)):
            if mode == FINISH:
                _all_reduce(dot, group)
            nvcc.check_launch("gated_norm_backward", lib.gn_bwd_launch(
                dt, way == "vector", mode, rows, w, p, float(width or w),
                *args, stream))
    BWD_LAUNCHES += 1
    ROUTE_LAUNCHES[way] += 1
    return dy, dxs, dz, dD, dscale
