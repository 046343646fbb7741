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

The backward, :func:`ssd_scan_backward` (``csrc/ssd_scan_bwd.cu``, its own
library ``build/kernels/libssd_scan_bwd.so``), gives ``dx, ddt, dA, dB,
dC`` from ``dy`` and the final state's cotangent, on the same two routes.
The chunked route takes the forward's incoming chunk states
(``ssd_scan(..., keep_states=True)``; a backward chunk that is the second
half of a forward chunk advances its saved state over the first half),
walks the chunks in reverse for the state's cotangent and runs one pass
for the gradients over slabs of a group's heads (bfloat16 inputs on the
tensor cores, float32 inputs on float32 FMAs; chunks of
:func:`backward_chunk` positions); the generic route runs the exact
per-token recurrence in reverse, its states recomputed from per-segment
checkpoints.  Sums over the heads of a group (``dB``, ``dC``) and over
batch and sequence (``dA``) go through per-slab (generic: per-head)
partials and a fixed-order reduction, so two calls give the same bits.
:func:`ssd_scan_backward_plain` is the same chunked decomposition in eager
float32 PyTorch: the oracle the kernel is held against, and the CPU's
version.
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

# Kernel launches (never the plain version's calls), in all and by route,
# of the forward and of the backward.
LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
BWD_LAUNCHES = 0
BWD_ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)

_lib = None
_bwd_lib = None


def reset_counts() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = 0
    ROUTE_LAUNCHES.update(dict.fromkeys(ROUTES, 0))
    BWD_LAUNCHES = 0
    BWD_ROUTE_LAUNCHES.update(dict.fromkeys(ROUTES, 0))


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


def ssd_scan_plain(x, dt, A, B, C, keep_states: bool = False,
                   chunk: int | None = None):
    """The exact recurrence, called as :func:`ssd_scan`; with
    ``keep_states`` a third item: the state entering each chunk of
    ``chunk`` positions ``[Bt, ceil(S / chunk), H, N, P]`` float32 (what the
    kernel's chunked route keeps for the backward), or None without a
    ``chunk``."""
    out = ssd_ref(x, dt, A, B, C, keep_every=chunk)
    y, state = out[0].to(x.dtype), out[1]
    if not keep_states:
        return y, state
    return y, state, out[2] if chunk else None


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


def ssd_scan(x, dt, A, B, C, keep_states: bool = False):
    """SSD scan; returns ``(y, final_state)``, and with ``keep_states`` a
    third item: on the chunked route the state entering each of the
    kernel's chunks ``[Bt, n_chunks, H, N, P]`` float32 (the scratch the
    kernel leaves them in, chunks of :func:`inner_chunk` positions), which
    :func:`ssd_scan_backward` takes; None on the generic route and on the
    CPU, whose backward recomputes them."""
    global LAUNCHES
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, keep_states)
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
    return (y, state, states) if keep_states else (y, state)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def generic_bwd_smem_bytes(n: int, p: int) -> int:
    """Shared memory of the generic backward: the state and its cotangent
    [N, P], B_t and C_t, x_t, dy_t and two [P] partial sums, in float32."""
    return 4 * (2 * n * p + 2 * n + 4 * p)


def backward_route(n: int, p: int, dtype: torch.dtype) -> str:
    """The backward's route: the forward's (:func:`route`), and on the
    generic route a state and its cotangent that fit a block's shared
    memory together.  Raises beyond that."""
    path = route(n, p, dtype)
    if path == "generic" and generic_bwd_smem_bytes(n, p) > MAX_BLOCK_SMEM:
        raise ValueError(f"ssd_scan backward takes N, P whose float32 state "
                         f"and cotangent fit {MAX_BLOCK_SMEM} bytes of "
                         f"shared memory, got N={n}, P={p}")
    return path


def backward_chunk(path: str, n: int, p: int, dtype: torch.dtype) -> int:
    """Positions per chunk of the chunked backward (per checkpointed
    segment of the generic one) at ``n, p`` on ``dtype`` inputs, as the
    built library states it."""
    return _load_bwd().ssd_scan_bwd_chunk(ROUTES.index(path), n, p,
                                          _DTYPES[dtype])


def backward_parts(h: int, g: int) -> int:
    """``dB``/``dC`` partials per position of the chunked backward: each
    group's heads in slabs of ``ssd_scan_bwd_slab_heads()``, one part per
    slab."""
    slab = _load_bwd().ssd_scan_bwd_slab_heads()
    return g * -(-(h // g) // slab)


def backward_scratch_bytes(bt: int, s: int, h: int, n: int, p: int,
                           dtype: torch.dtype, g: int = 1) -> int:
    """Bytes of the backward's float32 scratch for one call.  Chunked
    route: the cotangent of the state leaving each of the forward's chunks
    ``[Bt, ceil(S / inner_chunk), H, N, P]``, per-slab ``dB``/``dC``
    ``[Bt, S, parts, N]`` each (:func:`backward_parts`) and ``dA``
    partials ``[Bt, chunks, H]``; the forward's incoming states, which it
    reads too, are the forward's scratch, not counted here.  Generic
    route: per-head ``dB``/``dC`` ``[Bt, S, H, N]`` each, the segment
    checkpoints ``[Bt, H, segments, N, P]``, one segment's states
    ``[Bt, H, chunk, N, P]`` and ``dA`` partials ``[Bt, H]``."""
    path = backward_route(n, p, dtype)
    k = backward_chunk(path, n, p, dtype)
    nc = -(-s // k)
    if path == "chunked":
        ncf = n_chunks(s, dtype)
        return 4 * (bt * ncf * h * n * p + 2 * bt * s * backward_parts(h, g)
                    * n + bt * nc * h)
    return 4 * (2 * bt * s * h * n + bt * h * (nc + k) * n * p + bt * h)


def ssd_scan_backward_plain(x, dt, A, B, C, dy, dfinal=None,
                            chunk: int = 64, states=None,
                            states_chunk: int | None = None):
    """Gradients of :func:`ssd_scan`'s ``(y, final_state)`` with respect
    to ``x, dt, A, B, C``, given ``dy`` and ``dfinal`` (the final state's
    cotangent, or None for zero), by the kernel's chunked decomposition in
    eager float32: each chunk's incoming state, the reverse walk over
    chunks ``dS_{c-1} = exp(total_c) dS_c + C^T (exp(cum) * dy)_c`` seeded
    by ``dfinal``, and the chunk pass.  The incoming states are recomputed
    from zero, or, given ``states`` (the state entering each chunk of
    ``states_chunk`` positions, a multiple of ``chunk``, as
    ``ssd_scan_plain(..., True, states_chunk)`` or the kernel's forward
    keeps them), taken from there and advanced over the chunks before
    this one inside the same ``states_chunk``, as the kernel does.  Any
    ``S``: positions past the last chunk multiple are padded with dt = 0
    and zeros.  Returns ``dx`` in ``x``'s type, ``ddt`` and ``dA`` in
    float32, ``dB`` and ``dC`` in ``B``'s type."""
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    l = chunk
    nc = -(-s // l)
    pad = nc * l - s

    def chunked(t, width):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((bt, pad, *t.shape[2:]))], dim=1)
        return t.reshape(bt, nc, l, *t.shape[2:]) if width else \
            t.reshape(bt, nc, l, h)

    xc, dyc = chunked(x, True), chunked(dy, True)          # [b,c,l,h,p]
    dtc = chunked(dt, False)                                # [b,c,l,h]
    Bh = torch.repeat_interleave(chunked(B, True), rep, dim=3)  # [b,c,l,h,n]
    Ch = torch.repeat_interleave(chunked(C, True), rep, dim=3)
    Af = A.float()
    cum = torch.cumsum(dtc * Af, dim=2)                     # [b,c,l,h]
    total = cum[:, :, -1]                                   # [b,c,h]
    e = torch.exp(total[:, :, None] - cum)                  # exp(total-cum)
    ein = torch.exp(cum)

    # each chunk's incoming state, and the cotangent of its outgoing state
    contrib = torch.einsum("bclhn,bclh,bclhp->bchnp", Bh, e * dtc, xc)
    dcontrib = torch.einsum("bclhn,bclh,bclhp->bchnp", Ch, ein, dyc)
    decay = torch.exp(total)                                # [b,c,h]
    state = x.new_zeros((bt, h, n, p), dtype=torch.float32)
    per = nc                    # our chunks per saved state: none saved
    if states is not None:
        if not states_chunk or states_chunk % l or tuple(states.shape) != (
                bt, -(-s // states_chunk), h, n, p):
            raise ValueError(f"states [Bt, ceil(S / states_chunk), H, N, P] "
                             f"at a multiple of chunk={l}, got "
                             f"{tuple(states.shape)}, states_chunk="
                             f"{states_chunk}")
        per = states_chunk // l
    prev = []
    for c in range(nc):
        if states is not None and c % per == 0:
            state = states[:, c // per].float()
        prev.append(state)
        state = state * decay[:, c, :, None, None] + contrib[:, c]
    ds = (torch.zeros_like(state) if dfinal is None else dfinal.float())
    nxt = [None] * nc
    for c in reversed(range(nc)):
        nxt[c] = ds
        ds = ds * decay[:, c, :, None, None] + dcontrib[:, c]
    s_prev = torch.stack(prev, dim=1)                       # [b,c,h,n,p]
    ds_next = torch.stack(nxt, dim=1)

    # the chunk pass: W[i, j] = exp(cum_i - cum_j) for i >= j
    ch = cum.movedim(-1, 2)                                 # [b,c,h,l]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    w = torch.exp(torch.where(mask, ch[..., :, None] - ch[..., None, :],
                              torch.full_like(ch[..., None], -torch.inf)))
    dtj = dtc.movedim(-1, 2)[..., None, :]                  # [b,c,h,1,l]
    scores = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    m = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)
    sw = scores * w
    mwd = m * w * dtj
    t = sw * dtj * m
    dcum = (t.sum(-1) - t.sum(-2)).movedim(2, -1)           # [b,c,l,h]

    bds = torch.einsum("bcjhn,bchnp->bcjhp", Bh, ds_next)
    dxdt = e[..., None] * bds + torch.einsum("bchij,bcihp->bcjhp", sw, dyc)
    dx = dtc[..., None] * dxdt
    ddt = (xc * dxdt).sum(-1)
    u = e * dtc * (bds * xc).sum(-1)
    dcum = dcum - u
    dtotal = u.sum(2) + decay * (s_prev * ds_next).sum((-2, -1))
    dbh = (dtc * e)[..., None] * torch.einsum("bcjhp,bchnp->bcjhn", xc,
                                              ds_next) \
        + torch.einsum("bchij,bcihn->bcjhn", mwd, Ch)
    dch = ein[..., None] * torch.einsum("bcihp,bchnp->bcihn", dyc, s_prev) \
        + torch.einsum("bchij,bcjhn->bcihn", mwd, Bh)
    cs = torch.einsum("bcihn,bchnp->bcihp", Ch, s_prev)
    dcum = dcum + ein * (cs * dyc).sum(-1)
    dcum[:, :, -1] += dtotal
    d_da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = ddt + Af * d_da
    dA = (dtc * d_da).sum((0, 1, 2))

    def unchunk(t):
        return t.reshape(bt, nc * l, *t.shape[3:])[:, :s]

    dB = unchunk(dbh).reshape(bt, s, g, rep, n).sum(3)
    dC = unchunk(dch).reshape(bt, s, g, rep, n).sum(3)
    return (unchunk(dx).to(x.dtype), unchunk(ddt), dA, dB.to(B.dtype),
            dC.to(C.dtype))


def start_build_backward(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/ssd_scan_bwd.cu`` (as :func:`start_build`)."""
    return nvcc.start("ssd_scan_bwd", NVCC_FLAGS, verbose)


def _load_bwd():
    global _bwd_lib
    if _bwd_lib is None:
        lib = nvcc.load("ssd_scan_bwd", NVCC_FLAGS)
        fn = lib.ssd_scan_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_bwd_chunk.argtypes = [ctypes.c_int] * 4
        lib.ssd_scan_bwd_chunk.restype = ctypes.c_int
        lib.ssd_scan_bwd_slab_heads.argtypes = []
        lib.ssd_scan_bwd_slab_heads.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


def ssd_scan_backward(x, dt, A, B, C, dy, dfinal=None, states=None):
    """Gradients of :func:`ssd_scan` (see :func:`ssd_scan_backward_plain`);
    returns ``(dx, ddt, dA, dB, dC)``.  A CUDA tensor launches the kernel
    on the route :func:`backward_route` names; the chunked route needs the
    forward's incoming chunk states (``ssd_scan(..., keep_states=True)``),
    the generic route takes none.  A CPU tensor takes the plain version,
    which recomputes the states (the CPU's forward keeps none)."""
    global BWD_LAUNCHES
    if x.device.type == "cpu":
        return ssd_scan_backward_plain(x, dt, A, B, C, dy, dfinal)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_backward: unsupported device {x.device}")
    _check(x, dt, A, B, C)
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    path = backward_route(n, p, x.dtype)
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError(f"ssd_scan_backward needs a contiguous dy like x, "
                         f"got {dy.dtype} {tuple(dy.shape)}")
    if dfinal is not None and (dfinal.dtype != torch.float32 or tuple(
            dfinal.shape) != (bt, h, n, p) or not dfinal.is_contiguous()):
        raise ValueError(f"ssd_scan_backward needs a contiguous float32 "
                         f"dfinal [Bt,H,N,P], got {dfinal.dtype} "
                         f"{tuple(dfinal.shape)}")
    fwd_chunk = 0
    if path == "chunked":
        fwd_chunk = inner_chunk(x.dtype)
        want = (bt, -(-s // fwd_chunk), h, n, p)
        if states is None or states.dtype != torch.float32 or tuple(
                states.shape) != want or not states.is_contiguous():
            raise ValueError(
                f"ssd_scan_backward's chunked route needs the forward's "
                f"contiguous float32 chunk states {want} "
                f"(ssd_scan(..., keep_states=True)), got "
                f"{None if states is None else tuple(states.shape)}")
        if dy.data_ptr() % 16:
            raise ValueError("ssd_scan_backward needs a 16-byte aligned dy")
    elif states is not None:
        raise ValueError("ssd_scan_backward's generic route takes no states")
    lib = _load_bwd()
    k = backward_chunk(path, n, p, x.dtype)
    nc = -(-s // k)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    dx = torch.empty_like(x)
    ddt, dA = f32(bt, s, h), f32(h)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    if path == "chunked":
        # the cotangent of the state leaving each forward chunk; per-slab
        # dB/dC parts
        scratch_a, scratch_b = f32(*want), None
        parts = backward_parts(h, g)
        da_part = f32(bt, nc, h)
    else:
        # segment checkpoints and one segment's states per (batch, head);
        # per-head dB/dC parts
        scratch_a, scratch_b = f32(bt, h, nc, n, p), f32(bt, h, k, n, p)
        parts = h
        da_part = f32(bt, 1, h)
    db_part, dc_part = f32(bt, s, parts, n), f32(bt, s, parts, n)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), ptr(dfinal), ptr(states),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), scratch_a.data_ptr(), ptr(scratch_b),
            db_part.data_ptr(), dc_part.data_ptr(), da_part.data_ptr(), bt,
            s, h, g, n, p, _DTYPES[x.dtype], nc, fwd_chunk,
            ROUTES.index(path), stream)
    nvcc.check_launch("ssd_scan_backward", err)
    BWD_LAUNCHES += 1
    BWD_ROUTE_LAUNCHES[path] += 1
    return dx, ddt, dA, dB, dC
