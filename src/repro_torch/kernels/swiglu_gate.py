"""The SwiGLU gate (K10), forward and backward.

Between the gate and up products and the down product of a gated MLP, with
``g = x @ w_gate``, ``u = x @ w_up`` of one type ``T``::

    h = T(T(silu(float(g))) * u)

and from the cotangent ``dh``, rounded where autograd rounds::

    du = T(dh * a),  a = T(silu(float(g)))
    dg = T(silu'(float(g)) * T(dh * u))

Two versions of each function live here:

- :func:`swiglu_gate` and :func:`swiglu_gate_backward` — the wrappers.
  CUDA tensors launch the hand-written kernels in ``csrc/swiglu_gate.cu``
  (built with ``nvcc`` at first use into ``build/kernels/libswiglu_gate.so``
  and bound with ``ctypes``), one elementwise launch each, over a grid of
  one wave.  :func:`route` picks the kernels' loads: 16-byte vectors where
  the tensors are whole vectors and start on 16-byte boundaries, else
  element by element.  CPU and meta tensors take the plain versions.
  There is no fallback: a CUDA input the kernels do not take raises.
- :func:`swiglu_gate_plain` — the JAX package's gate
  (``src/repro/models/layers.py:73``) in eager torch ops, exactly the ops
  the model ran before, and :func:`swiglu_gate_backward_plain`, its
  gradient in the same torch ops autograd runs (``aten.silu_backward``),
  so on the CPU it is autograd's, bit for bit.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import nvcc

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VECTOR_BYTES = 16
ROUTES = ("vector", "scalar")
BLOCKS_PER_SM = 8              # 256-thread blocks: one wave of the card

# Kernel launches (never the plain versions' calls): forward calls and
# backward calls, and both by route
LAUNCHES = 0
BWD_LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)

_lib = None
_SMS: dict[int, int] = {}


def reset_counts() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = 0
    BWD_LAUNCHES = 0
    for k in ROUTES:
        ROUTE_LAUNCHES[k] = 0


def chunk(dtype) -> int:
    """Elements of ``dtype`` in a 16-byte vector."""
    return VECTOR_BYTES // dtype.itemsize


def route(n: int, dtype, tensors) -> str:
    """``"vector"`` where ``n`` elements are whole 16-byte vectors of
    ``dtype`` and every tensor given starts on a 16-byte boundary, else
    ``"scalar"`` (one element a step)."""
    if n % chunk(dtype) == 0 and all(t.data_ptr() % VECTOR_BYTES == 0
                                     for t in tensors):
        return "vector"
    return "scalar"


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def swiglu_gate_plain(g, u):
    """``silu(float(g))`` rounded to ``u``'s type, times ``u``."""
    return F.silu(g.float()).to(u.dtype) * u


def swiglu_gate_backward_plain(dh, g, u):
    """Gradients of :func:`swiglu_gate_plain` from ``dh``: ``(dg, du)`` in
    the inputs' type, by the ops autograd runs for it."""
    a = F.silu(g.float()).to(u.dtype)
    du = dh * a
    dg = torch.ops.aten.silu_backward((dh * u).float(), g.float())
    return dg.to(g.dtype), du


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


def start_build(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/swiglu_gate.cu`` for sm_90a; ``wait()`` on
    the result installs the library and returns the compiler's
    diagnostics."""
    return nvcc.start("swiglu_gate", (), verbose)


def _load():
    global _lib
    if _lib is None:
        lib = nvcc.load("swiglu_gate")
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.sg_fwd_launch.argtypes = [i, i, ll, i] + [p] * 4
        lib.sg_bwd_launch.argtypes = [i, i, ll, i] + [p] * 6
        for fn in (lib.sg_fwd_launch, lib.sg_bwd_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _blocks(device) -> int:
    """One wave of 256-thread blocks on ``device`` (its SM count read
    once)."""
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index] * BLOCKS_PER_SM


def _check(g, u, more=()) -> int:
    """Elements; raises on what the kernels do not take."""
    if g.dtype not in _DTYPES:
        raise TypeError(f"swiglu_gate kernel takes float32 or bfloat16, got "
                        f"{g.dtype}")
    for t in (u, *more):
        if t.shape != g.shape or t.dtype != g.dtype:
            raise ValueError(f"swiglu_gate: {tuple(t.shape)} {t.dtype} "
                             f"beside {tuple(g.shape)} {g.dtype}")
    for t in (g, u, *more):
        if t.device != g.device:
            raise ValueError(f"swiglu_gate: a tensor on {t.device}, not "
                             f"{g.device}")
        if not t.is_contiguous():
            raise ValueError("swiglu_gate needs contiguous tensors")
    if g.numel() == 0:
        raise ValueError("swiglu_gate: no elements")
    return g.numel()


def swiglu_gate(g, u):
    """The gate (as :func:`swiglu_gate_plain`).  CUDA tensors launch the
    kernel; CPU and meta tensors take the plain version."""
    global LAUNCHES
    if g.device.type in ("cpu", "meta"):
        return swiglu_gate_plain(g, u)
    if g.device.type != "cuda":
        raise ValueError(f"swiglu_gate: unsupported device {g.device}")
    n = _check(g, u)
    lib = _load()
    h = torch.empty_like(g)
    way = route(n, g.dtype, (g, u, h))
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        nvcc.check_launch("swiglu_gate", lib.sg_fwd_launch(
            _DTYPES[g.dtype], way == "vector", n, _blocks(g.device),
            g.data_ptr(), u.data_ptr(), h.data_ptr(), stream))
    LAUNCHES += 1
    ROUTE_LAUNCHES[way] += 1
    return h


def swiglu_gate_backward(dh, g, u):
    """Gradients (as :func:`swiglu_gate_backward_plain`): ``(dg, du)``.
    CUDA tensors launch the kernel; CPU and meta tensors take the plain
    version."""
    global BWD_LAUNCHES
    if g.device.type in ("cpu", "meta"):
        return swiglu_gate_backward_plain(dh, g, u)
    if g.device.type != "cuda":
        raise ValueError(f"swiglu_gate_backward: unsupported device "
                         f"{g.device}")
    n = _check(g, u, (dh,))
    lib = _load()
    dg, du = torch.empty_like(g), torch.empty_like(u)
    way = route(n, g.dtype, (dh, g, u, dg, du))
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        nvcc.check_launch("swiglu_gate_backward", lib.sg_bwd_launch(
            _DTYPES[g.dtype], way == "vector", n, _blocks(g.device),
            dh.data_ptr(), g.data_ptr(), u.data_ptr(), dg.data_ptr(),
            du.data_ptr(), stream))
    BWD_LAUNCHES += 1
    ROUTE_LAUNCHES[way] += 1
    return dg, du
