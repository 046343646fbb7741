"""Mixture-of-Experts layer: top-k router with sort-based scatter/gather
dispatch and optional shared experts / dense residual branch.

Dispatch: each routed slot's *rank within its expert* comes from a stable
argsort over expert ids (no [T, E, C] one-hot), and activations move by
scatter-add and gather:

    buffer[e, rank] += x[token]      (scatter)
    y[token]      = Σ_k gate · h[e_k, rank_k]   (gather)

Expert buffers are [E, C, d] with C = capacity = Tk·cf/E.  Slots ranked past
the capacity are dropped: they add exact zeros into ``(e, C-1)``, so the
buffer does not depend on the order in which the scatter adds.  The expert
products are batched matmuls over the expert axis, as in the JAX package
(no kernel of its own there either).

Covered architectures:

- deepseek-v3: 256 routed experts top-8 + 1 shared expert (sigmoid router,
  normalized top-k probs).
- arctic:      128 routed experts top-2 + a *dense residual* MLP in parallel
  (modeled via the shared-expert branch).
- jamba:       16 experts top-2, every other layer.

On a mesh the layer runs expert-parallel (:func:`moe_apply_ep`, the
counterpart of the JAX package's ``shard_map`` path): each rank routes its
local tokens to the experts it holds and one all-reduce over ``model``
combines them.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch.launch.ctx import get_hint
from repro_torch.models.layers import DEFAULT_DTYPE, dense_init, normal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0          # deepseek shared experts / arctic dense
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: torch.dtype = torch.float32
    sigmoid_router: bool = False       # deepseek-v3 uses sigmoid+normalize


def make_moe_params(gen: torch.Generator, cfg: MoEConfig,
                    dtype=DEFAULT_DTYPE) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    params = {
        "router": dense_init(gen, d, e, torch.float32),
        # stacked expert weights [E, d, f] / [E, f, d]
        "w_gate": normal(gen, (e, d, f), 1 / math.sqrt(d), dtype),
        "w_up": normal(gen, (e, d, f), 1 / math.sqrt(d), dtype),
        "w_down": normal(gen, (e, f, d), 1 / math.sqrt(f), dtype),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_ff_shared or cfg.d_ff_expert * cfg.n_shared_experts
        params["shared"] = {
            "w_gate": dense_init(gen, d, fs, dtype),
            "w_up": dense_init(gen, d, fs, dtype),
            "w_down": dense_init(gen, fs, d, dtype),
        }
    return params


def _router_probs(cfg: MoEConfig, logits: torch.Tensor):
    """Top-k routing probabilities.  logits: [T, E] (fp32)."""
    if cfg.sigmoid_router:
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(scores, cfg.top_k, dim=-1)   # [T, k]
    top_vals = top_vals / torch.clamp(
        torch.sum(top_vals, dim=-1, keepdim=True), min=1e-9)
    return top_vals, top_idx, scores


def capacity(cfg: MoEConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens."""
    return max(1, int(t * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def _dispatch(top_idx: torch.Tensor, n_experts: int, cap: int):
    """Each routed slot's expert, its rank within that expert (slots in
    token order), whether the rank fits the capacity, and the slots per
    expert.  top_idx: [T, k] -> flat_e, pos, keep [T*k], counts [E]."""
    flat_e = top_idx.reshape(-1)                           # [T*k]
    n = flat_e.numel()
    sidx = torch.argsort(flat_e, stable=True)              # sorted slot ids
    # [E]; a scatter, not torch.bincount, which reads the ids' maximum back
    # to the host on CUDA
    counts = torch.zeros(n_experts, dtype=flat_e.dtype,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts              # exclusive
    rank_sorted = torch.arange(n, device=flat_e.device) - starts[flat_e[sidx]]
    pos = torch.empty_like(flat_e).scatter_(0, sidx, rank_sorted)
    return flat_e, pos, pos < cap, counts


def _experts(buf, w_gate, w_up, w_down):
    """The expert MLPs, batched over the expert axis: [E, C, D] -> same."""
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, w_down)


def _shared(params, cfg: MoEConfig, out, x):
    if cfg.n_shared_experts and "shared" in params:
        sh = params["shared"]
        g = x @ sh["w_gate"]
        u = x @ sh["w_up"]
        hs = F.silu(g.float()).to(x.dtype) * u
        out = out + hs @ sh["w_down"]
    return out


def moe_apply(params, cfg: MoEConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE layer.  x: [B, S, D].  Returns (out, aux_loss).

    On a mesh — the ``moe_ep`` hint's, or that of a DTensor ``x`` — the
    dispatch runs expert-parallel (:func:`moe_apply_ep`) when the shapes
    divide the mesh; otherwise a DTensor layer runs the plain dispatch on
    the experts as they are split (:func:`_plain_on_mesh`)."""
    mesh = get_hint("moe_ep")
    if mesh is None and isinstance(x, DTensor):
        mesh = x.device_mesh
    if mesh is not None:
        out = _try_ep(params, cfg, x, mesh)
        if out is not None:
            return out
        if isinstance(x, DTensor):
            return _plain_on_mesh(params, cfg, x,
                                  get_hint("moe_mode") or "train")
    return _moe_plain(params, cfg, x)


def _moe_plain(params, cfg: MoEConfig, x: torch.Tensor):
    b, s, d = x.shape
    t = b * s
    k = cfg.top_k
    e = cfg.n_experts
    xt = x.reshape(t, d)
    logits = xt.to(cfg.router_dtype) @ params["router"]
    top_vals, top_idx, scores = _router_probs(cfg, logits)

    cap = capacity(cfg, t)
    flat_e, pos, keep, counts = _dispatch(top_idx, e, cap)
    pos_c = torch.clamp(pos, max=cap - 1)
    slot_token = torch.arange(t * k, device=x.device) // k

    # dispatch: scatter token activations into expert buffers [E, C, D]
    contrib = torch.where(keep[:, None], xt[slot_token],
                          torch.zeros((), dtype=xt.dtype, device=x.device))
    buf = torch.zeros((e, cap, d), dtype=xt.dtype, device=x.device).index_put(
        (flat_e, pos_c), contrib, accumulate=True)
    ye = _experts(buf, params["w_gate"], params["w_up"], params["w_down"])

    # combine: gather back and mix with gate values
    gathered = ye[flat_e, pos_c]                           # [T*k, D]
    gates = (top_vals.reshape(t * k) * keep).to(gathered.dtype)
    out = torch.sum((gathered * gates[:, None]).reshape(t, k, d), dim=1)

    # load-balance auxiliary loss (Switch):  E · Σ_e f_e · p_e
    me = counts.float() / (t * k)
    pe = torch.mean(scores, dim=0)
    aux = e * torch.sum(me * pe)

    out = _shared(params, cfg, out, xt)
    return out.reshape(b, s, d).to(x.dtype), aux.float()


# ---------------------------------------------------------------------------
# expert-parallel dispatch
# ---------------------------------------------------------------------------

def _size(mesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def _placed(t, mesh, placements) -> DTensor:
    """``t`` on ``mesh`` with ``placements``: a DTensor is redistributed,
    a plain tensor (the whole value on every rank) is distributed."""
    placements = tuple(placements)
    if not isinstance(t, DTensor):
        return distribute_tensor(t, mesh, list(placements))
    if tuple(t.placements) == placements:
        return t
    return t.redistribute(mesh, placements)


def _plain_on_mesh(params, cfg: MoEConfig, x: DTensor, mode: str):
    """The plain dispatch where the shapes do not divide the mesh (a batch
    smaller than the data axes), on the expert weights as they are split:
    every rank routes the whole batch to the experts it holds and the
    partial outputs are summed over the axes that split the experts
    (:func:`_dispatch_local` with the whole batch and the rank's offset).
    The experts stay split over the whole mesh where ``serve`` placed them
    so, and over ``model`` otherwise (each layer's data shards of the
    expert weights are gathered, as the train layout does).  The batch is
    gathered; no rank gathers the experts of a rank it sums with.  Where
    ``model`` does not divide the experts, or there is none, every rank
    holds them all."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    b, s, d = x.shape
    e = cfg.n_experts
    if mode == "serve" and e % mesh.size() == 0:
        axes = names
    else:
        axes = ("model",) if "model" in names and \
            e % _size(mesh, "model") == 0 else ()
    ways, rank = 1, 0
    for n in names:                       # linear index, mesh order
        if n in axes:
            ways *= _size(mesh, n)
            rank = rank * _size(mesh, n) + mesh.get_local_rank(n)

    def over(p):
        return tuple(p if n in axes else Replicate() for n in names)

    rep = (Replicate(),) * mesh.ndim
    w_layout, y_layout = over(Shard(0)), over(Partial())
    offset = rank * (e // ways)

    def inner(xl, router, wg, wu, wd):
        y, aux = _dispatch_local(cfg, xl.reshape(b * s, d), router, wg, wu,
                                 wd, offset)
        # every rank routes the same tokens: the aux is a sum of equal
        # shares over the ranks that split the experts
        return y.reshape(b, s, d), aux / ways

    fn = local_map(inner, out_placements=(y_layout, y_layout),
                   in_placements=(rep, rep, w_layout, w_layout, w_layout),
                   in_grad_placements=(y_layout, y_layout, w_layout,
                                       w_layout, w_layout),
                   device_mesh=mesh)
    y, aux = fn(_placed(x, mesh, rep), _placed(params["router"], mesh, rep),
                *(_placed(params[w], mesh, w_layout)
                  for w in ("w_gate", "w_up", "w_down")))
    y = y.redistribute(mesh, [Replicate() if p.is_partial() else p
                              for p in x.placements])
    y = _shared(params, cfg, y, x)
    return y.to(x.dtype), aux.redistribute(mesh, rep).float()


def _try_ep(params, cfg: MoEConfig, x, mesh):
    """The expert-parallel path when the shapes divide the mesh; None ->
    the plain dispatch."""
    names = mesh.mesh_dim_names
    tp = _size(mesh, "model") if "model" in names else 1
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    dpn = 1
    for a in dp_axes:
        dpn *= _size(mesh, a)
    b = x.shape[0]
    if (cfg.n_experts % tp != 0 or b % max(dpn, 1) != 0 or b < dpn
            or "model" not in names):
        return None
    mode = get_hint("moe_mode") or "train"
    return moe_apply_ep(params, cfg, x, mesh, dp_axes, mode)


def _dispatch_local(cfg: MoEConfig, xt, router, wg, wu, wd, offset: int):
    """Route the tokens ``xt`` [T, D] to the ``wg.shape[0]`` experts this
    rank holds, numbered from ``offset``; other slots contribute nothing.
    Returns this rank's partial output (the sum over ranks is the layer's)
    and the aux loss of these tokens.  The JAX package's ``_dispatch_full``
    (decode: the whole gathered batch, a full-mesh offset) is this with
    the gathered tokens and that offset."""
    tl, d = xt.shape
    k, e = cfg.top_k, cfg.n_experts
    e_local = wg.shape[0]
    cap = capacity(cfg, tl)
    logits = xt.to(cfg.router_dtype) @ router
    top_vals, top_idx, scores = _router_probs(cfg, logits)
    flat_e, pos, keep, counts = _dispatch(top_idx, e, cap)
    keep = keep & (flat_e >= offset) & (flat_e < offset + e_local)
    le = torch.clamp(flat_e - offset, 0, e_local - 1)
    pos_c = torch.clamp(pos, max=cap - 1)
    slot_token = torch.arange(tl * k, device=xt.device) // k

    contrib = torch.where(keep[:, None], xt[slot_token],
                          torch.zeros((), dtype=xt.dtype, device=xt.device))
    buf = torch.zeros((e_local, cap, d), dtype=xt.dtype,
                      device=xt.device).index_put((le, pos_c), contrib,
                                                  accumulate=True)
    ye = _experts(buf, wg, wu, wd)
    gathered = ye[le, pos_c]
    gates = (top_vals.reshape(tl * k) * keep).to(gathered.dtype)
    y = torch.sum((gathered * gates[:, None]).reshape(tl, k, d), dim=1)

    me = counts.float() / (tl * k)
    pe = torch.mean(scores, dim=0)
    return y, e * torch.sum(me * pe)


def moe_apply_ep(params, cfg: MoEConfig, x, mesh, dp_axes, mode: str):
    """Expert parallelism with explicit collectives (DTensor
    redistributions around a ``local_map``).

    mode="train": expert weights enter (E→model, d→dp) ZeRO-sharded and
    ONE LAYER of them is all-gathered over dp; each rank routes its local
    tokens to its model-rank's experts, and the combine is one all-reduce
    over ``model`` (a partial sum made whole).

    mode="serve": weights enter EP-sharded over the full mesh when the
    expert count allows it.  Decode (tiny token counts) gathers the TOKENS
    over dp instead: every rank routes the whole batch to its own expert
    slice, and the partial outputs are summed over the whole mesh and
    split back by batch.  Prefill gathers weights over dp like train.
    The full-mesh expert split is in mesh order (``pod``, ``data``,
    ``model``): a rank's experts start at its linear mesh index times its
    expert count.
    """
    b, s, d = x.shape
    e = cfg.n_experts
    names = mesh.mesh_dim_names
    tp = _size(mesh, "model")
    dpn = 1
    for a in dp_axes:
        dpn *= _size(mesh, a)
    t_local = (b // max(dpn, 1)) * s
    full_ep = mode == "serve" and e % (tp * dpn) == 0
    gather_tokens = full_ep and t_local * cfg.top_k <= 1024   # decode

    def layout(dp, model):
        return tuple(model if n == "model" else
                     (dp if n in dp_axes else Replicate()) for n in names)

    rep = (Replicate(),) * mesh.ndim
    part = (Partial(),) * mesh.ndim
    x_layout = layout(Shard(0), Replicate())
    x = _placed(x, mesh, x_layout)
    if gather_tokens:
        x_in, w_layout = rep, (Shard(0),) * mesh.ndim
        rank = 0
        for n in names:                       # linear index, mesh order
            rank = rank * _size(mesh, n) + mesh.get_local_rank(n)
        y_layout = x_grad = part
        w_grad = w_layout
    else:
        x_in, w_layout = x_layout, layout(Replicate(), Shard(0))
        rank = mesh.get_local_rank("model")
        y_layout = x_grad = layout(Shard(0), Partial())
        w_grad = layout(Partial(), Shard(0))   # each dp rank's own tokens
    offset = rank * (e // (mesh.size() if gather_tokens else tp))

    def inner(xl, router, wg, wu, wd):
        bl = xl.shape[0]
        y, aux = _dispatch_local(cfg, xl.reshape(bl * s, d), router, wg, wu,
                                 wd, offset)
        # the layer's aux is the mean over ranks: a sum of shares
        return y.reshape(bl, s, d), aux / mesh.size()

    # every rank's output is a partial sum, and so is each input's
    # gradient over the axes where ranks hold the same input and use it
    # differently
    fn = local_map(inner, out_placements=(y_layout, part),
                   in_placements=(x_in, rep, w_layout, w_layout, w_layout),
                   in_grad_placements=(x_grad, part, w_grad, w_grad,
                                       w_grad),
                   device_mesh=mesh)
    y, aux = fn(_placed(x, mesh, x_in), _placed(params["router"], mesh, rep),
                *(_placed(params[w], mesh, w_layout)
                  for w in ("w_gate", "w_up", "w_down")))
    y = y.redistribute(mesh, x_layout)       # the combine
    aux = aux.redistribute(mesh, rep)
    y = _shared(params, cfg, y, x)
    return y.to(x.dtype), aux.float()
