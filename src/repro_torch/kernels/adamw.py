"""AdamW update (K5): the global gradient norm, clipping, the moments, the
bias-corrected step with decoupled weight decay, and the NaN-skip, over a
list of tensors, in place or into new tensors.

Two versions of one function live here:

- :func:`adamw_step_` — the wrapper.  CUDA tensors launch the
  hand-written kernel in ``csrc/adamw.cu`` (built with ``nvcc`` at first
  use into ``build/kernels/libadamw.so`` and bound with ``ctypes``): three
  CUDA kernels over every tensor, the norm's per-chunk sums, their fixed-
  order total with the clip scale, the skip flag and the step count, and
  the update.  CPU tensors take the plain version.  There is no fallback
  from one to the other: CUDA inputs the kernel does not take (a
  DTensor, a dtype other than float32 or bfloat16, a strided tensor) raise.
- :func:`adamw_step_plain_` — the update as the port's optimizer wrote
  it before the kernel, tensor by tensor in eager float32 torch ops,
  written back through ``torch.where(ok, new, old)``: the oracle the
  kernel is held against, and the CPU's version.

Both take a mesh rank's local shards (``groups``: the process groups
whose ranks hold the other shards; ``counted``: which of this rank's
tensors enter the norm, so that a shard replicated over ranks counts
once).  The norm is then split at its reduction: this rank's partial sum
of squares, its all-reduce (sum, float64) over ``groups`` in turn, and
the rest from the total.  On the card that is four CUDA kernels, the
fused total's block run as two (``adamw_sum``, ``adamw_finish_total``)
around the all-reduce; with one rank the total is the fused kernel's, bit
for bit.

Per element, in float32, each operation rounded on its own::

    g' = g * scale;  m' = m * b1 + g' * (1 - b1)
    v' = v * b2 + (g' * g') * (1 - b2)
    delta = (m' / c1) / (sqrt(v' / c2) + eps)    [+ weight_decay * p]
    p' = p - lr * delta

with ``scale = min(1, grad_clip / (|g| + 1e-9))`` from the global norm
``|g|``, ``c1 = 1 - b1 ** t``, ``c2 = 1 - b2 ** t`` at ``t = step + 1``.
Where the loss (if given) or the norm is not finite, nothing changes and
``step`` does not advance.  The results round to each tensor's dtype.

The kernel's update is bitwise equal to the plain version's wherever the
two scales are equal (the norm under ``grad_clip`` makes both exactly 1);
its norm sums in another order (per chunk, then the chunks in double), so
with clipping the scale, and through it the results, may differ by an ulp.

In place, the kernel works from a :class:`Table` of the parameters and
moments in device memory, built once for a set of tensors (cached by
their pointers, so a CUDA graph captured after a first eager call finds
it and copies nothing from the host); the gradients' pointers travel with
each launch.  Out of place, a table is built for each call.  A captured
graph reads its table by pointer after the cache may have dropped it, so
whoever keeps the graph keeps the tables of the calls captured in it
(:func:`holding_tables`).
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.kernels import nvcc

# elements a block of the kernel covers: one chunk of one tensor
CHUNK = 32768
NVCC_FLAGS = (f"-DADAMW_CHUNK={CHUNK}",)
ROW = 8                       # int64 words a table row holds
P_BF16, G_BF16, M_BF16, DECAY = 1, 2, 4, 256
NO_NORM = 512                 # this rank leaves the row out of the norm
_TYPES = (torch.float32, torch.bfloat16)
NORM_EPS = 1e-9               # the plain version's gnorm + 1e-9

# Kernel launches (never the plain version's calls): CUDA kernels, three a
# call, four with ``groups``.
LAUNCHES = 0

_lib = None
_TABLES: collections.OrderedDict = collections.OrderedDict()
_TABLE_CACHE = 4
_HOLDERS: list[list] = []        # the open holding_tables() lists


def reset_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def norm_partial(grads, counted=None):
    """The sum of squares of the gradients ``counted`` (all by default),
    float32 0-d: a sum of per-tensor float32 sums, in their order."""
    sq = [torch.sum(torch.square(g.float())) for i, g in enumerate(grads)
          if counted is None or counted[i]]
    if not sq:
        return torch.zeros((), dtype=torch.float32, device=grads[0].device)
    return sum(sq)


def all_reduce_sum(total, groups):
    """``total`` summed in place over the ranks of each of ``groups`` in
    turn (``None``: the default group)."""
    for group in groups:
        dist.all_reduce(total, group=group)
    return total


def global_sum(partial, groups):
    """A rank's float32 ``partial`` summed over ``groups`` in float64
    (:func:`all_reduce_sum`), back in float32; without groups ``partial``
    itself."""
    if not groups:
        return partial
    return all_reduce_sum(partial.double(), groups).float()


def grad_norm(grads):
    """The global norm of a list of gradients, float32 0-d, as the plain
    version computes it (a sum of per-tensor float32 sums)."""
    return torch.sqrt(norm_partial(grads))


def clip_scale(gnorm, grad_clip: float):
    """``min(1, grad_clip / (gnorm + 1e-9))``, as torch computes it."""
    return torch.clamp(grad_clip / (gnorm + NORM_EPS), max=1.0)


def bias_corrections(step, b1: float, b2: float):
    """``(step + 1, 1 - b1 ** t, 1 - b2 ** t)`` at ``t = step + 1`` in
    float32, by torch scalar ops on ``step``'s device."""
    new_step = step + 1
    t = new_step.float()
    return new_step, 1 - b1 ** t, 1 - b2 ** t


def update_tensor(g, m, v, p, decay: bool, scale, c1, c2, *, lr, b1, b2,
                  eps, weight_decay):
    """One tensor's new ``(p, m, v)`` in their dtypes, computed in float32
    (each op rounded on its own, the order the kernel follows)."""
    g = g.float() * scale
    m32 = m.float() * b1 + g * (1 - b1)
    v32 = v.float() * b2 + g * g * (1 - b2)
    delta = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
    if decay:
        delta = delta + weight_decay * p.float()
    return ((p.float() - lr * delta).to(p.dtype), m32.to(m.dtype),
            v32.to(v.dtype))


def adamw_step_plain_(grads, params, ms, vs, step, decays, *, lr, b1, b2,
                      eps, weight_decay, grad_clip, loss=None, out=None,
                      counted=None, groups=None):
    """The update over lists ``grads``, ``params``, ``ms``, ``vs`` (one
    entry per tensor) and the int32 0-d ``step``; ``decays[i]`` turns on
    weight decay for tensor ``i``.  With ``out=None`` it writes the
    parameters, moments and ``step`` in place; with ``out=(params_out,
    ms_out, vs_out, step_out)`` it writes those instead and leaves the
    inputs as they were.  On a mesh rank's local shards, the norm sums the
    tensors ``counted`` and is all-reduced over ``groups``
    (:func:`global_sum`).  Returns the global norm (float32, 0-d)."""
    gnorm = torch.sqrt(global_sum(norm_partial(grads, counted), groups))
    scale = clip_scale(gnorm, grad_clip)
    new_step, c1, c2 = bias_corrections(step, b1, b2)
    ok = torch.isfinite(gnorm)
    if loss is not None:
        ok = ok & torch.isfinite(loss)
    dst = (params, ms, vs, step) if out is None else out
    for i, (g, p, m, v) in enumerate(zip(grads, params, ms, vs,
                                         strict=True)):
        new = update_tensor(g, m, v, p, decays[i], scale, c1, c2, lr=lr,
                            b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
        for d, n, o in zip((dst[0][i], dst[1][i], dst[2][i]), new, (p, m, v)):
            d.copy_(torch.where(ok, n, o))
    dst[3].copy_(torch.where(ok, new_step, step))
    return gnorm


# ---------------------------------------------------------------------------
# the tensor table
# ---------------------------------------------------------------------------


def code(p_dtype, g_dtype, m_dtype, decay: bool, counted: bool = True) -> int:
    """A row's dtype, decay and norm code, as the source reads it."""
    return ((P_BF16 if p_dtype == torch.bfloat16 else 0)
            | (G_BF16 if g_dtype == torch.bfloat16 else 0)
            | (M_BF16 if m_dtype == torch.bfloat16 else 0)
            | (DECAY if decay else 0)
            | (0 if counted else NO_NORM))


def plan(numels, codes) -> tuple[list[int], list[int]]:
    """The table's row order (tensor indices, grouped by dtype code, in
    their own order within a group) and the chunk prefix of the rows in
    that order (``len(rows) + 1`` entries; row ``r`` owns chunks
    ``prefix[r] .. prefix[r + 1] - 1``)."""
    order = sorted(range(len(numels)), key=lambda i: codes[i] & 7)
    prefix = [0]
    for i in order:
        prefix.append(prefix[-1] + -(-numels[i] // CHUNK))
    return order, prefix


def chunk_range(prefix, numels_in_order, c: int) -> tuple[int, int, int]:
    """(row, first element, end) of chunk ``c``: the kernel's binary search
    for the last row whose prefix is <= ``c``."""
    r = bisect.bisect_right(prefix, c, 0, len(prefix) - 1) - 1
    k = c - prefix[r]
    return r, k * CHUNK, min((k + 1) * CHUNK, numels_in_order[r])


@dataclasses.dataclass
class Table:
    """The rows of one set of tensors in device memory (``tab``: ``ROW``
    int64 words a row, then the chunk prefix), with what the host needs to
    launch over them."""
    order: list[int]
    prefix: list[int]
    tab: torch.Tensor

    @property
    def n_chunks(self) -> int:
        return self.prefix[-1]


def _check(name: str, ts, dev) -> None:
    for t in ts:
        if t.dtype not in _TYPES:
            raise TypeError(f"adamw kernel: {name} of dtype {t.dtype}; the "
                            f"kernel takes float32 and bfloat16")
        if t.device != dev:
            raise ValueError(f"adamw kernel: {name} on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"adamw kernel: {name} is not contiguous")


def build_table(grads, params, ms, vs, decays, outs=None,
                counted=None) -> Table:
    """The table of ``params``, ``ms``, ``vs`` (written to ``outs =
    (params_out, ms_out, vs_out)``, or in place) for gradients of the
    dtypes of ``grads``, the norm summing the rows ``counted`` (all by
    default), copied to the device."""
    dev = params[0].device
    capacity = _load().adamw_grad_capacity()
    if len(params) > capacity:
        raise ValueError(f"adamw kernel: {len(params)} tensors; one launch "
                         f"carries the gradient pointers of {capacity}")
    po, mo, vo = outs if outs is not None else (params, ms, vs)
    numels = [p.numel() for p in params]
    counted = counted or [True] * len(params)
    codes = [code(p.dtype, g.dtype, m.dtype, d, c)
             for p, g, m, d, c in zip(params, grads, ms, decays, counted)]
    order, prefix = plan(numels, codes)
    rows = []
    for i in order:
        rows += [params[i].data_ptr(), ms[i].data_ptr(), vs[i].data_ptr(),
                 po[i].data_ptr(), mo[i].data_ptr(), vo[i].data_ptr(),
                 numels[i], codes[i]]
    tab = torch.tensor(rows + prefix, dtype=torch.int64).to(dev)
    return Table(order, prefix, tab)


def _key(grads, params, ms, vs, decays, counted=None) -> tuple:
    """What an in-place table's contents depend on."""
    return (params[0].device, tuple(g.dtype for g in grads), tuple(decays),
            None if counted is None else tuple(counted),
            tuple((t.data_ptr(), t.numel(), t.dtype) for ls in (params, ms, vs)
                  for t in ls))


def table_for(grads, params, ms, vs, decays, counted=None) -> Table:
    """The in-place table of these tensors, from the cache or built (and
    cached: the pointers stay those of the tensors updated in place)."""
    key = _key(grads, params, ms, vs, decays, counted)
    table = _TABLES.get(key)
    if table is None:
        table = build_table(grads, params, ms, vs, decays, counted=counted)
        _TABLES[key] = table
        while len(_TABLES) > _TABLE_CACHE:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
    return table


@contextlib.contextmanager
def holding_tables():
    """A list that gathers the table of every kernel call made inside the
    block.  A CUDA graph captured in the block reads those tables by
    pointer at each replay, and the cache keeps only the last
    ``_TABLE_CACHE``, so the graph's owner keeps the list as long as the
    graph."""
    held: list[Table] = []
    _HOLDERS.append(held)
    try:
        yield held
    finally:
        _HOLDERS.remove(held)


def scratch_bytes(table: Table) -> int:
    """Device bytes one call allocates beside its outputs, as the caching
    allocator counts them (512-byte blocks): the norm's float32 slot per
    chunk, its three float32 results, and the 0-d tensors of the bias
    corrections (at most four alive at once)."""
    def block(n: int) -> int:
        return -(-n // 512) * 512
    return block(4 * max(table.n_chunks, 1)) + block(4 * 3) + 4 * 512


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


def start_build(verbose: bool = False) -> nvcc.Build:
    """Start compiling ``csrc/adamw.cu`` for sm_90a; ``wait()`` on the
    result installs the library and returns the compiler's diagnostics
    (``-Xptxas -v`` when ``verbose``)."""
    return nvcc.start("adamw", NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = nvcc.load("adamw", NVCC_FLAGS)
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.adamw_norm_launch.argtypes = [p, i, ll, p, p, p]
        lib.adamw_finish_launch.argtypes = [p, ll, p, f, f, p, p, p, p]
        lib.adamw_sum_launch.argtypes = [p, ll, p, p]
        lib.adamw_finish_total_launch.argtypes = [p, p, f, f, p, p, p, p]
        lib.adamw_apply_launch.argtypes = [p, i, ll, p, p, p, p] + [f] * 7 \
            + [p]
        for fn in (lib.adamw_norm_launch, lib.adamw_finish_launch,
                   lib.adamw_sum_launch, lib.adamw_finish_total_launch,
                   lib.adamw_apply_launch, lib.adamw_grad_capacity,
                   lib.adamw_chunk):
            fn.restype = ctypes.c_int
        if lib.adamw_chunk() != CHUNK:
            raise RuntimeError(f"libadamw built with chunk "
                               f"{lib.adamw_chunk()}, not {CHUNK}")
        _lib = lib
    return _lib


def adamw_step_(grads, params, ms, vs, step, decays, *, lr, b1, b2, eps,
                weight_decay, grad_clip, loss=None, out=None, counted=None,
                groups=None):
    """The update (as :func:`adamw_step_plain_`, same arguments and
    result).  CUDA tensors launch the kernel: in place (``out=None``) from
    the cached :func:`table_for` these tensors, out of place from a table
    built for the call; with ``groups`` the norm's total is all-reduced
    between ``adamw_sum`` and ``adamw_finish_total``.  CPU tensors take
    the plain version."""
    global LAUNCHES
    n = len(params)
    if not (len(grads) == len(ms) == len(vs) == len(decays) == n) or n == 0:
        raise ValueError("adamw: grads, params, moments and decay flags "
                         "differ in count, or are empty")
    if counted is not None:
        counted = [bool(c) for c in counted]
        if len(counted) != n:
            raise ValueError("adamw: one norm flag per tensor")
    groups = list(groups or [])
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for ls in (grads, params, ms, vs)
           for t in ls):
        raise TypeError("adamw: DTensors are updated shard by shard by the "
                        "optimizer's mesh path, not by this function")
    dev = params[0].device
    if dev.type == "cpu" and all(t.device.type == "cpu" for ls in (
            grads, params, ms, vs) for t in ls):
        return adamw_step_plain_(grads, params, ms, vs, step, decays, lr=lr,
                                 b1=b1, b2=b2, eps=eps,
                                 weight_decay=weight_decay,
                                 grad_clip=grad_clip, loss=loss, out=out,
                                 counted=counted, groups=groups)
    if dev.type != "cuda":
        raise ValueError(f"adamw: unsupported device {dev}")
    for name, ls in (("a gradient", grads), ("a parameter", params),
                     ("a first moment", ms), ("a second moment", vs)):
        _check(name, ls, dev)
    if out is not None:
        for name, ls in zip(("a parameter out", "a first moment out",
                             "a second moment out"), out[:3]):
            _check(name, ls, dev)
    for i in range(n):
        p, g, m, v = params[i], grads[i], ms[i], vs[i]
        if not g.numel() == p.numel() == m.numel() == v.numel():
            raise ValueError(f"adamw kernel: tensor {i} sizes differ")
        if m.dtype != v.dtype:
            raise TypeError(f"adamw kernel: tensor {i} moments of dtypes "
                            f"{m.dtype} and {v.dtype}")
        if out is not None and (out[0][i].dtype != p.dtype
                                or out[1][i].dtype != m.dtype
                                or out[2][i].dtype != v.dtype):
            raise TypeError(f"adamw kernel: tensor {i} out of another dtype")
    step_out = step if out is None else out[3]
    for s in (step, step_out):
        if s.dtype != torch.int32 or s.dim() != 0 or s.device != dev:
            raise TypeError("adamw kernel: step must be a 0-d int32 tensor "
                            "on the card")
    if loss is not None:
        if loss.dim() != 0 or loss.device != dev:
            raise ValueError("adamw kernel: loss must be 0-d on the card")
        loss = loss.float()
    table = table_for(grads, params, ms, vs, decays, counted) \
        if out is None else \
        build_table(grads, params, ms, vs, decays, out[:3], counted)
    for held in _HOLDERS:
        held.append(table)

    lib = _load()
    # c1, c2 by the plain version's own scalar ops, so they are its bits
    c1, c2 = bias_corrections(step, b1, b2)[1:]
    slots = torch.empty(max(table.n_chunks, 1), dtype=torch.float32,
                        device=dev)
    scal = torch.empty(3, dtype=torch.float32, device=dev)
    gptr = (ctypes.c_void_p * n)(*[grads[i].data_ptr()
                                    for i in table.order])
    tab = table.tab.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        nvcc.check_launch("adamw_norm", lib.adamw_norm_launch(
            tab, n, table.n_chunks, gptr, slots.data_ptr(), stream))
        finish = (None if loss is None else loss.data_ptr(), grad_clip,
                  NORM_EPS, step.data_ptr(), step_out.data_ptr(),
                  scal.data_ptr(), stream)
        if groups:
            total = torch.empty((), dtype=torch.float64, device=dev)
            nvcc.check_launch("adamw_sum", lib.adamw_sum_launch(
                slots.data_ptr(), table.n_chunks, total.data_ptr(), stream))
            all_reduce_sum(total, groups)
            nvcc.check_launch("adamw_finish_total",
                              lib.adamw_finish_total_launch(
                                  total.data_ptr(), *finish))
        else:
            nvcc.check_launch("adamw_finish", lib.adamw_finish_launch(
                slots.data_ptr(), table.n_chunks, *finish))
        nvcc.check_launch("adamw_apply", lib.adamw_apply_launch(
            tab, n, table.n_chunks, gptr, scal.data_ptr(), c1.data_ptr(),
            c2.data_ptr(), b1, 1 - b1, b2, 1 - b2, lr, weight_decay, eps,
            stream))
    LAUNCHES += 4 if groups else 3
    return scal[0]
