"""The models' entry to the attention and SSD kernels.

On a CUDA tensor these launch the hand-written kernels (K2
:mod:`repro_torch.kernels.flash_attention`, K3
:mod:`repro_torch.kernels.ssd_scan`) on the route each kernel's ``route``
names from the shape and type: every head dim up to 256 for K2 and every
N, P whose state fits a block's shared memory for K3, so the reduced
configs run on the card too.  A CUDA input outside every route raises; it
never drops to another path.  On a CPU tensor they run the
models' own chunked PyTorch paths, exactly what the JAX package runs off
the TPU (``attention_any``, ``ssd_chunked``).  Same function, so the
models' results do not depend on the dispatch beyond rounding.

K2 and K3 have backwards: on CUDA, where autograd needs a gradient, they
run as :class:`FlashAttention` and :class:`SSDScan`, autograd Functions
whose forward is the kernel and whose backward is its backward kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention_backward`,
:func:`repro_torch.kernels.ssd_scan.ssd_scan_backward`), so training runs
attention and the SSD through K2 and K3 in both directions.  On the CPU
autograd differentiates the plain paths, as the JAX package does.

The Mamba block's fused work goes through here too: the causal conv with
its SiLU (K6, :mod:`repro_torch.kernels.mamba_conv`, under autograd
:class:`CausalConv`), the D skip with the gated norm (K7,
:mod:`repro_torch.kernels.gated_norm`, :class:`GatedNorm`) and the
decode's one-token state step with its convs, which writes the layer's
states in place (K8, :mod:`repro_torch.kernels.mamba_decode`): the
kernels on CUDA, in both directions where training needs them; their
plain versions on the CPU and the meta device, which autograd
differentiates.

Every layer's own fused work goes through here too: the residual add
with the next RMSNorm (K9, :mod:`repro_torch.kernels.unit_norm`, under
autograd :class:`AddRMSNorm`) and the SwiGLU gate (K10,
:mod:`repro_torch.kernels.swiglu_gate`, :class:`SwiGLUGate`), in both
directions; on the CPU and the meta device their plain versions, which are
the ops the models ran before, so a model's bits there do not move.

On DTensors (a model placed on a mesh) all of them run per rank on the
local batch and heads through ``local_map`` (:func:`attention_per_rank`,
:func:`ssd_per_rank`, which the training forward's plain paths use too;
the conv on each rank's channels, the gated norm on each rank's share of
a row with its sums of squares all-reduced over ``model``):
the inputs are first redistributed to batch over the data axes as they
come and heads over ``model`` when the heads divide it, replicated
otherwise.  On the meta device (the dry run) they
run the plain paths, which only propagate shapes there.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import flash_attention as _k2
from repro_torch.kernels import gated_norm as _k7
from repro_torch.kernels import mamba_conv as _k6
from repro_torch.kernels import mamba_decode as _k8
from repro_torch.kernels import ssd_scan as _k3
from repro_torch.kernels import swiglu_gate as _k10
from repro_torch.kernels import unit_norm as _k9


def _cpu_only(t, meta: bool = False) -> None:
    """The plain path runs on the CPU, and on the meta device for a mesh
    (the dry run's shards); anywhere else there is neither it nor a
    kernel."""
    if t.device.type != "cpu" and not (meta and t.device.type == "meta"):
        raise ValueError(f"no kernel or plain path for device {t.device}")


def _no_backward(kernel: str, *inputs) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{kernel} has no backward: an input requires grad, and the "
            f"kernel's output would not carry it; differentiate the plain "
            f"path (models.attention.attention_any) or call under "
            f"torch.no_grad()")


class FlashAttention(torch.autograd.Function):
    """K2 under autograd: the output by the forward kernel, which also keeps
    each row's log-sum-exp; the gradients of ``q, k, v`` by K2's backward
    kernel from the saved ``q, k, v``, output and log-sum-exp (a missing
    cotangent counts as zero).  On the CPU and the meta device the same
    through the plain forward and backward, for the tests; the models'
    path there is ``attention_any`` under autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.set_materialize_grads(False)
        out, lse = _k2.flash_attention(q, k, v, causal=causal, window=window,
                                       scale=scale, return_lse=True)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = torch.zeros_like(out) if dout is None else dout.contiguous()
        return (*_k2.flash_attention_backward(
            q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window,
            scale=ctx.scale), None, None, None)


class SSDScan(torch.autograd.Function):
    """K3 under autograd: ``(y, final_state)`` by the forward kernel, the
    gradients of ``x, dt, A, B, C`` by the backward kernel from the
    cotangents of both outputs (a missing one counts as zero).  The
    forward's incoming chunk states (its scratch, float32 [Bt, chunks, H,
    N, P]; none on the generic route) are saved for the backward, which
    then does not recompute them."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        ctx.set_materialize_grads(False)
        y, final, states = _k3.ssd_scan(x, dt, A, B, C, keep_states=True)
        ctx.save_for_backward(x, dt, A, B, C, states)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dfinal is not None:
            dfinal = dfinal.contiguous()
        return _k3.ssd_scan_backward(x, dt, A, B, C, dy, dfinal, states)


class CausalConv(torch.autograd.Function):
    """K6 under autograd, without states: the outputs of ``n`` segments
    (``xs``, then their weights, then their biases) by the forward kernel,
    the gradients of all of them by the backward kernel."""

    @staticmethod
    def forward(ctx, n, *ts):
        ctx.n = n
        ctx.save_for_backward(*ts)
        ys, _ = _k6.causal_conv(list(ts[:n]), list(ts[n:2 * n]),
                                list(ts[2 * n:]))
        return tuple(ys)

    @staticmethod
    def backward(ctx, *gs):
        n, ts = ctx.n, ctx.saved_tensors
        dxs, dws, dbs = _k6.causal_conv_backward(
            list(ts[:n]), list(ts[n:2 * n]), list(ts[2 * n:]),
            [g.contiguous() for g in gs])
        return (None, *dxs, *dws, *dbs)


class GatedNorm(torch.autograd.Function):
    """K7 under autograd: the D skip and gated norm by the forward kernel,
    the gradients of ``y, xs, z, D, scale`` by the backward kernel (from the
    forward's per-row rstd); with ``group`` both split their row sums
    around an all-reduce over it."""

    @staticmethod
    def forward(ctx, y, xs, z, D, scale, eps, group, width):
        out, rstd = _k7.gated_norm(y, xs, z, D, scale, eps, group, width)
        ctx.group, ctx.width = group, width
        ctx.save_for_backward(y, xs, z, D, scale, rstd)
        return out

    @staticmethod
    def backward(ctx, dout):
        y, xs, z, D, scale, rstd = ctx.saved_tensors
        return (*_k7.gated_norm_backward(dout.contiguous(), y, xs, z, D,
                                         scale, rstd, ctx.group, ctx.width),
                None, None, None)


class AddRMSNorm(torch.autograd.Function):
    """K9 under autograd: ``(s, y)`` by the forward kernel (``y`` alone
    without ``h``), the gradients of ``x``, ``h`` (the same tensor) and
    ``scale`` by the backward kernel from the saved ``s`` and the rows'
    rstd; a missing cotangent of ``s`` adds nothing, of ``y`` counts as
    zero."""

    @staticmethod
    def forward(ctx, x, h, scale, eps):
        ctx.set_materialize_grads(False)
        s, y, rstd = _k9.add_rmsnorm(x, h, scale, eps)
        ctx.add = h is not None
        ctx.save_for_backward(s, scale, rstd)
        return (s, y) if ctx.add else y

    @staticmethod
    def backward(ctx, *grads):
        s, scale, rstd = ctx.saved_tensors
        ds, dy = grads if ctx.add else (None, grads[0])
        dy = torch.zeros_like(s) if dy is None else dy.contiguous()
        if ds is not None:
            ds = ds.contiguous()
        d, dscale = _k9.add_rmsnorm_backward(dy, ds, s, scale, rstd)
        return d, (d if ctx.add else None), dscale, None


class SwiGLUGate(torch.autograd.Function):
    """K10 under autograd: the gate by the forward kernel, the gradients of
    ``g`` and ``u`` by the backward kernel from the saved ``g`` and ``u``
    (in their own type)."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return _k10.swiglu_gate(g, u)

    @staticmethod
    def backward(ctx, dh):
        g, u = ctx.saved_tensors
        return _k10.swiglu_gate_backward(dh.contiguous(), g, u)


def model_size(x: DTensor) -> int:
    """The size of the ``model`` axis of ``x``'s mesh (1 without one)."""
    names = x.device_mesh.mesh_dim_names
    return x.device_mesh.shape[names.index("model")] if "model" in names \
        else 1


def _redistributed(t, mesh, layout: tuple) -> DTensor:
    """``t`` on ``layout``; a plain tensor made beside the DTensors is the
    whole value on every rank (replicated)."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t if tuple(t.placements) == layout else \
        t.redistribute(mesh, layout)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: gradients
    leaving a ``local_map`` go on through views of the DTensor's local
    tensors, which a transposed gradient cannot take."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def per_rank(fn, args, dims, out_dims, split: bool):
    """``fn(*args)`` on each rank's local tensors, through ``local_map``.

    ``args[0]`` is a DTensor and sets the batch layout: dimension 0 of
    every argument and output with a batch dimension stays split over the
    data axes where ``args[0]``'s is, and is gathered otherwise.  ``dims``
    and ``out_dims`` give each argument's and output's ``(batch, heads)``:
    whether its dimension 0 is the batch, and which dimension goes over
    ``model`` when ``split`` (``None``: replicated there).

    An argument replicated over an axis on which the others are split
    (no batch dimension on a data axis that splits the batch; no heads
    while the heads are split over ``model``) feeds a different
    computation on each rank of that axis, so its gradient is a partial
    sum there (``in_grad_placements``)."""
    x = args[0]
    mesh = x.device_mesh

    def layout(batch, heads, grad=False):
        model = Replicate()
        if split and heads is not None:
            model = Shard(heads)
        elif split and grad:
            model = Partial()
        out = []
        for name, p in zip(mesh.mesh_dim_names, x.placements):
            if name == "model":
                out.append(model)
            elif p == Shard(0):
                out.append(Shard(0) if batch else
                           (Partial() if grad else Replicate()))
            else:
                out.append(Replicate())
        return tuple(out)

    in_layouts = tuple(layout(*d) for d in dims)
    grad_layouts = tuple(layout(*d, grad=True) for d in dims)
    out_layouts = tuple(layout(*d) for d in out_dims)

    def local(*ls):
        return fn(*(_ContiguousGrad.apply(t) if t.requires_grad else t
                    for t in ls))

    mapped = local_map(local, out_placements=out_layouts,
                       in_placements=in_layouts,
                       in_grad_placements=grad_layouts, device_mesh=mesh)
    return mapped(*(_redistributed(t, mesh, lay)
                    for t, lay in zip(args, in_layouts)))


def attention_per_rank(fn, q, k, v):
    """``fn(q, k, v)`` (attention over [B, S, H, D] tensors) on each rank's
    local batch and heads when ``q`` is a DTensor; query heads go over
    ``model`` when they divide it and the key heads divide it too or are
    one (MQA: keys replicated); otherwise every rank takes all heads.  On
    plain tensors it is ``fn(q, k, v)``."""
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    hkv = k.shape[2]
    split = q.shape[2] % model_size(q) == 0 and (
        hkv % model_size(q) == 0 or hkv == 1)
    kv = (True, 2 if hkv > 1 else None)
    return per_rank(fn, (q, k, v), ((True, 2), kv, kv), ((True, 2),),
                    split)


def ssd_per_rank(fn, x, dt, A, B, C, *heads, chunk_size: int):
    """``fn(x, dt, A, B, C, *heads, chunk_size)`` (the SSD, returning
    ``(y, final_state)``; ``heads``: more [H] vectors) on each rank's local
    batch and heads when ``x`` is a DTensor; heads go over ``model`` when
    they divide it and the groups do too or are one (B and C replicated).
    On plain tensors it is the call."""
    if not isinstance(x, DTensor):
        return fn(x, dt, A, B, C, *heads, chunk_size)
    tp = model_size(x)
    g = B.shape[2]
    split = x.shape[2] % tp == 0 and (g == 1 or g % tp == 0)
    bc = (True, 2 if g > 1 else None)                 # [Bt, S, G, N]
    return per_rank(lambda *a: fn(*a, chunk_size), (x, dt, A, B, C, *heads),
                    ((True, 2), (True, 2), (False, 0), bc, bc)
                    + ((False, 0),) * len(heads),
                    ((True, 2), (True, 1)), split)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    chunk_size: int = 512, dense_threshold: int = 2048):
    """Causal GQA attention.  ``chunk_size`` and ``dense_threshold`` steer
    the CPU path only."""
    kw = dict(causal=causal, window=window, scale=scale,
              chunk_size=chunk_size, dense_threshold=dense_threshold)
    if isinstance(q, DTensor):
        return attention_per_rank(
            functools.partial(_flash_attention, meta=True, **kw), q, k, v)
    return _flash_attention(q, k, v, **kw)


def _flash_attention(q, k, v, *, causal, window, scale, chunk_size,
                     dense_threshold, meta: bool = False):
    if q.device.type == "cuda":
        if _wants_grad(q, k, v):
            return FlashAttention.apply(q, k, v, causal, window, scale)
        return _k2.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    _cpu_only(q, meta)
    from repro_torch.models.attention import attention_any
    return attention_any(q, k, v, causal=causal, window=window,
                         chunk_size=chunk_size,
                         dense_threshold=dense_threshold, scale=scale)


def ssd_scan(x, dt, A, B, C, *, chunk_size: int = 128):
    """Mamba-2 SSD; returns ``(y, final_state)``.  ``chunk_size`` is the
    CPU path's chunk (it must divide S there); the kernel uses its own."""
    return _ssd_scan(x, dt, A, B, C, chunk_size)


def local_ssd_scan(x, dt, A, B, C, *, chunk_size: int = 128):
    """:func:`ssd_scan` on one rank's local tensors, inside a computation
    that ``ssd_per_rank`` maps over a mesh: the kernel on CUDA, the plain
    path on the CPU or on the meta device (the dry run's shards)."""
    return _ssd_scan(x, dt, A, B, C, chunk_size, meta=True)


def _ssd_scan(x, dt, A, B, C, chunk_size, meta: bool = False):
    if x.device.type == "cuda":
        return SSDScan.apply(x, dt, A, B, C)
    _cpu_only(x, meta)
    from repro_torch.models.mamba import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, chunk_size)


def _contiguous(ts):
    return [None if t is None else t.contiguous() for t in ts]


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def causal_conv(xs, ws, bs, states=None, want_state: bool = False):
    """The Mamba block's causal conv with its SiLU over segments ``xs``
    (lists of [Bt, S, C_j] with weights [K, C_j] and biases [C_j];
    ``states``: [Bt, K-1, C_j] each, or None for zeros).  Returns the
    outputs and, with ``states`` or ``want_state``, the new states (the
    last K-1 rows of each padded input; else None), as lists.  On DTensors
    it runs per rank on each rank's channels (all segments split over
    ``model`` where each one's channels divide it, else replicated)."""
    if not isinstance(xs[0], DTensor):
        return local_causal_conv(xs, ws, bs, states, want_state)
    n = len(xs)
    with_state = states is not None or want_state
    args = (*xs, *ws, *bs, *(states or ()))
    dims = ((True, 2),) * n + ((False, 1),) * n + ((False, 0),) * n + \
        ((True, 2),) * len(states or ())

    def local(*a):
        ys, new = local_causal_conv(
            list(a[:n]), list(a[n:2 * n]), list(a[2 * n:3 * n]),
            list(a[3 * n:]) if states is not None else None, want_state)
        return tuple(ys) + (tuple(new) if with_state else ())

    outs = per_rank(local, args, dims,
                    ((True, 2),) * (2 * n if with_state else n),
                    all(x.shape[-1] % model_size(xs[0]) == 0 for x in xs))
    return list(outs[:n]), (list(outs[n:]) if with_state else None)


def local_causal_conv(xs, ws, bs, states=None, want_state: bool = False):
    """:func:`causal_conv` on one rank's local tensors (or a single
    device's): K6 on CUDA (under :class:`CausalConv` where autograd needs
    its gradient), the plain version on the CPU and the meta device."""
    if xs[0].device.type != "cuda":
        return _k6.causal_conv(xs, ws, bs, states, want_state)
    xs, ws, bs = _contiguous(xs), _contiguous(ws), _contiguous(bs)
    if states is None and not want_state and _wants_grad(*xs, *ws, *bs):
        return list(CausalConv.apply(len(xs), *xs, *ws, *bs)), None
    _no_backward("K6 (the causal conv) with a state", *xs, *ws, *bs)
    return _k6.causal_conv(xs, ws, bs, None if states is None
                           else _contiguous(states), want_state)


def gated_norm(y, xs, z, D, scale, eps: float = _k7.EPS):
    """The Mamba block's D skip (with ``D``; ``xs``, ``D`` None: none) and
    gated norm over the last dimension (``y``, ``xs``, ``z`` [..., W]).  On
    DTensors it runs per rank on each rank's share of a row (split over
    ``model`` where the heads divide it; the rows' sums of squares, and the
    backward's row dots, all-reduced over ``model``), else on whole rows."""
    if not isinstance(z, DTensor):
        return local_gated_norm(y, xs, z, D, scale, eps)
    tp = model_size(z)
    split = (D.shape[0] if D is not None else z.shape[-1]) % tp == 0
    mesh = z.device_mesh
    group = mesh.get_group("model") if split and tp > 1 else None
    width = z.shape[-1]
    if D is None:
        return per_rank(
            lambda z_, y_, s_: local_gated_norm(y_, None, z_, None, s_, eps,
                                                group, width),
            (z, y, scale), ((True, 2), (True, 2), (False, 0)), ((True, 2),),
            split)
    return per_rank(
        lambda z_, y_, x_, d_, s_: local_gated_norm(y_, x_, z_, d_, s_, eps,
                                                    group, width),
        (z, y, xs, D, scale),
        ((True, 2), (True, 2), (True, 2), (False, 0), (False, 0)),
        ((True, 2),), split)


def local_gated_norm(y, xs, z, D, scale, eps: float = _k7.EPS, group=None,
                     width: int | None = None):
    """:func:`gated_norm` on one rank's local tensors (or a single
    device's), ``width`` the whole row's: K7 on CUDA (under
    :class:`GatedNorm` where autograd needs its gradient), the plain
    version on the CPU and the meta device."""
    if z.device.type != "cuda":
        return _k7.gated_norm(y, xs, z, D, scale, eps, group, width)[0]
    y, xs, z = _contiguous((y, xs, z))
    if _wants_grad(y, xs, z, D, scale):
        if D is None:
            raise RuntimeError("K7 without the D skip has no backward")
        return GatedNorm.apply(y, xs, z, D, scale, eps, group, width)
    return _k7.gated_norm(y, xs, z, D, scale, eps, group, width)[0]


def decode_layer(xs, B, C, dt, ws, bs, states, ssm, dt_bias, A_log, D):
    """The Mamba layer's one-token state step (K8's function): the convs
    from ``states`` (xs, B, C: [Bt, K-1, ·]), dt, the decay, the state
    update and the D skip, from the projections ``xs`` [Bt, 1, H*P],
    ``B``/``C`` [Bt, 1, G*N], the raw ``dt`` [Bt, 1, H], the conv weights
    ``ws`` and biases ``bs`` (lists: xs, B, C), the float32 ``ssm`` [Bt, H,
    N, P] and the layer's [H] vectors.  Returns ``(y, states, ssm)``: y
    [Bt, H, P] and the states written.  On plain tensors those are the
    given objects, written in place.  On DTensors the step runs per rank on
    the local batch and heads (heads, and xs's channels, over ``model``
    when they, and the groups or a single group, divide it; B and C whole
    on every rank of a single group) and writes each rank's local tensors,
    which may be redistributed copies: keep what is returned."""
    if not isinstance(xs, DTensor):
        return (local_decode_layer(xs, B, C, dt, ws, bs, states, ssm,
                                   dt_bias, A_log, D), states, ssm)
    tp = model_size(xs)
    g = B.shape[-1] // ssm.shape[2]
    heads = (True, 2)                                 # [Bt, ., channels]
    bc = (True, 2 if g > 1 else None)
    vec = (False, 0)
    args = (xs, B, C, dt, *ws, *bs, *states, ssm, dt_bias, A_log, D)
    dims = (heads, bc, bc, heads, (False, 1), (False, 1 if g > 1 else None),
            (False, 1 if g > 1 else None), vec, (False, 0 if g > 1 else None),
            (False, 0 if g > 1 else None), heads, bc, bc, (True, 1), vec, vec,
            vec)

    def local(xs_, B_, C_, dt_, wx, wB, wC, bx, bB, bC, sx, sB, sC, ssm_,
              dt_bias_, A_log_, D_):
        y = local_decode_layer(xs_, B_, C_, dt_, [wx, wB, wC], [bx, bB, bC],
                               [sx, sB, sC], ssm_, dt_bias_, A_log_, D_)
        return y, sx, sB, sC, ssm_

    y, sx, sB, sC, ssm = per_rank(
        local, args, dims, ((True, 1), heads, bc, bc, (True, 1)),
        dt.shape[-1] % tp == 0 and (g == 1 or g % tp == 0))
    return y, [sx, sB, sC], ssm


def local_decode_layer(xs, B, C, dt, ws, bs, states, ssm, dt_bias, A_log,
                       D):
    """:func:`decode_layer` on one rank's local tensors (or a single
    device's): K8 on CUDA, the plain version on the CPU and the meta
    device; returns ``y`` and writes ``states`` and ``ssm`` in place."""
    if xs.device.type == "cuda":
        _no_backward("K8 (the decode's state step)", xs, B, C, dt, ssm)
        xs, B, C, dt = _contiguous((xs, B, C, dt))
        return _k8.decode_layer(xs, B, C, dt, _contiguous(ws),
                                _contiguous(bs), states, ssm, dt_bias,
                                A_log, D)
    return _k8.decode_layer(xs, B, C, dt, ws, bs, states, ssm, dt_bias,
                            A_log, D)


def add_rmsnorm(x, h, scale, eps: float = _k9.EPS):
    """The residual add of the pending branch output ``h`` into the stream
    ``x`` (``h`` None: nothing pending) and the RMSNorm of the sum over
    the last dimension; returns ``(s, y)``, the new stream and its norm
    (``s`` is ``x`` without ``h``).  On DTensors it runs per rank on whole
    rows: batch over the data axes as ``x``'s, replicated over ``model``
    (no mesh splits d_model there; a branch output that holds partial sums
    over ``model`` is summed first), the scale's gradient a partial sum
    over the batch axes."""
    if not isinstance(x, DTensor):
        return local_add_rmsnorm(x, h, scale, eps)
    row, vec = (True, None), (False, None)
    if h is None:
        return x, per_rank(
            lambda x_, s_: local_add_rmsnorm(x_, None, s_, eps)[1],
            (x, scale), (row, vec), (row,), False)
    return per_rank(lambda x_, h_, s_: local_add_rmsnorm(x_, h_, s_, eps),
                    (x, h, scale), (row, row, vec), (row, row), False)


def local_add_rmsnorm(x, h, scale, eps: float = _k9.EPS):
    """:func:`add_rmsnorm` on one rank's local tensors (or a single
    device's): K9 on CUDA (under :class:`AddRMSNorm` where autograd needs
    its gradient), the plain version on the CPU and the meta device."""
    if x.device.type != "cuda":
        return _k9.add_rmsnorm(x, h, scale, eps)[:2]
    x, h = _contiguous((x, h))
    if _wants_grad(x, h, scale):
        out = AddRMSNorm.apply(x, h, scale, eps)
        return out if h is not None else (x, out)
    return _k9.add_rmsnorm(x, h, scale, eps)[:2]


def swiglu_gate(g, u):
    """The SwiGLU gate ``silu(float(g))`` rounded to the type, times ``u``
    (``g``, ``u`` [..., F]).  On DTensors it runs per rank: batch over the
    data axes as ``g``'s, F over ``model`` where it divides it (the column-
    parallel products' layout), else replicated."""
    if not isinstance(g, DTensor):
        return local_swiglu_gate(g, u)
    last = (True, g.dim() - 1)
    return per_rank(local_swiglu_gate, (g, u), (last, last), (last,),
                    g.shape[-1] % model_size(g) == 0)


def local_swiglu_gate(g, u):
    """:func:`swiglu_gate` on one rank's local tensors (or a single
    device's): K10 on CUDA (under :class:`SwiGLUGate` where autograd needs
    its gradient), the plain version on the CPU and the meta device."""
    if g.device.type != "cuda":
        return _k10.swiglu_gate(g, u)
    g, u = _contiguous((g, u))
    if _wants_grad(g, u):
        return SwiGLUGate.apply(g, u)
    return _k10.swiglu_gate(g, u)
