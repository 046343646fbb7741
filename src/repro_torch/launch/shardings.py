"""Sharding rules: parameter, optimizer and activation specs.

Strategy, as in the JAX package:

- **TP** over the ``model`` axis: attention heads, MLP hidden dim, MoE
  expert axis (EP), vocab dim of embed/lm_head, mamba heads.
- **FSDP (ZeRO-3)** over ``data`` (and ``pod`` when present): the non-TP
  dimension of every large weight.
- Small or numerically sensitive leaves (norm scales, conv kernels,
  A_log, ...) are replicated.
- Activations: batch over ``(pod, data)``; long-context decode shards the
  KV-cache sequence dim over ``data`` instead (batch = 1).

A spec is a tuple with one entry per tensor dimension: an axis name, a
tuple of axis names (the dimension split over several axes, major first)
or ``None``.  :func:`to_placements` turns it into DTensor placements, one
per mesh dimension: ``Shard(d)`` on every axis that splits dimension ``d``,
``Replicate()`` on the others.  A dimension split over two axes is split
in mesh order (``pod`` before ``data`` before ``model``); the local shapes
are the JAX package's, and for the serving experts' ``("model", "pod",
"data")`` the experts a rank holds are numbered in mesh order
(:func:`repro_torch.models.moe.moe_apply_ep` follows the placement).

The port's ``params["units"]`` is a list of per-unit trees, not a tree
stacked on a leading ``[n_units]`` axis, so a unit leaf's spec is the JAX
package's without its leading ``None``.

Rules are name-based over the parameter tree's path, with divisibility
guards: a dimension that does not divide its axis is replicated.
"""
from __future__ import annotations

import dataclasses
import math

import torch.utils._pytree as pytree
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

# leaves whose LAST dim is TP-sharded (column parallel)
_COL_TP = {"w_q", "w_k", "w_v", "w_gate", "w_up", "w_uq", "w_dq", "w_uv",
           "w_dkv", "w_z", "w_x", "w_dt", "in_proj"}
# leaves whose FIRST dim is TP-sharded (row parallel)
_ROW_TP = {"w_o", "w_down", "w_uk", "out_proj"}
# replicated small leaves
_REPLICATED = {"norm1", "norm2", "final_norm", "norm_scale", "A_log",
               "dt_bias", "D", "conv_x_w", "conv_x_b", "conv_B_w", "conv_B_b",
               "conv_C_w", "conv_C_b", "router", "w_B", "w_C"}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names without devices or a process group
    (the counterpart of ``jax.sharding.AbstractMesh``): enough for every
    rule here and for local shapes."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def size(self) -> int:
        return math.prod(self.shape)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def _dp_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _dp_size(mesh) -> int:
    size = 1
    for a in ("pod", "data"):
        if a in mesh.mesh_dim_names:
            size *= _axis_size(mesh, a)
    return size


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _spec(*entries, ndim: int) -> tuple:
    """Pad to one entry per tensor dimension."""
    return tuple(entries) + (None,) * (ndim - len(entries))


def _path_names(path) -> list[str]:
    names = [getattr(k, "key", getattr(k, "name", None)) for k in path]
    return [n for n in names if isinstance(n, str)]


def param_spec(path: tuple, leaf, mesh, mode: str = "train",
               kv_shardable: bool = True,
               heads_shardable: bool = True) -> tuple:
    """Spec for one parameter leaf given its tree path.

    mode="train": TP over model + FSDP over (pod, data) — optimizer state
    must be sharded everywhere.
    mode="serve": TP over model only; weights replicated across the data
    axis; experts shard over model×data when divisible (EP across the
    full mesh).
    mode="fsdp": no TP; the ``model`` axis joins the FSDP group.
    """
    names = _path_names(path)
    leafname = names[-1] if names else ""
    shape = tuple(leaf.shape)
    nd = len(shape)
    tp = _axis_size(mesh, "model")
    dp = _dp_axes(mesh)
    dpn = _dp_size(mesh)
    if mode == "fsdp":
        all_axes = tuple(a for a in ("pod", "data", "model")
                         if a in mesh.mesh_dim_names)
        total = math.prod(_axis_size(mesh, a) for a in all_axes)
        if leafname in _REPLICATED or nd <= 1:
            return _spec(ndim=nd)
        if leafname in ("embed", "lm_head"):
            # never shard the d dim of embeddings (the logits contraction
            # would make full float32 [B,S,V] partials): vocab or nothing
            v = shape[0]
            if _div(v, total):
                return _spec(all_axes, None, ndim=nd)
            if _div(v, tp):
                return _spec("model", None, ndim=nd)
            return _spec(ndim=nd)
        for i in range(nd):
            if _div(shape[i], total):
                spec = [None] * nd
                spec[i] = all_axes
                return tuple(spec)
        return _spec(ndim=nd)
    if mode == "serve":
        # no FSDP for non-expert weights during serving
        dp = None
        # KV-side projections produce tensors with the cache's sharding:
        # when the KV heads (or the MLA latent) do not divide the TP axis
        # the cache is head-replicated, and so are these weights
        if leafname in ("w_k", "w_v", "w_dkv") and not kv_shardable:
            return _spec(ndim=nd)

    if leafname in _REPLICATED or nd <= 1:
        return _spec(ndim=nd)

    in_moe = any(n == "mlp" for n in names) and nd == 3
    if in_moe:
        e = shape[0]
        if mode == "serve":
            # EP across the whole mesh when the expert count allows it
            full = tuple(a for a in ("model", "pod", "data")
                         if a in mesh.mesh_dim_names)
            if _div(e, tp * dpn):
                return (full, None, None)
            return ("model" if _div(e, tp) else None, None, None)
        # train: EP over model + ZeRO-3 on the d dim; the weights are
        # gathered over dp one layer at a time inside the EP dispatch
        eax = "model" if _div(e, tp) else None
        if leafname == "w_down":            # [E, f, d]: shard d
            return (eax, None,
                    dp if dp is not None and _div(shape[2], dpn) else None)
        return (eax,                        # [E, d, f]: shard d
                dp if dp is not None and _div(shape[1], dpn) else None, None)

    if leafname in ("embed", "lm_head"):
        # vocab over model only (FSDP on d would gather the batch at the
        # logits)
        v = shape[0]
        return ("model" if _div(v, tp) else None, None)

    # attention projections take TP only when the head count divides the
    # TP axis; otherwise FSDP only (batch-parallel attention)
    attn_leaf = leafname in ("w_q", "w_k", "w_v", "w_o", "w_uq", "w_uk",
                             "w_uv", "w_dq", "w_dkv")
    tp_ok = heads_shardable or not attn_leaf

    if leafname in _COL_TP and nd == 2:
        d_in, d_out = shape
        return (dp if dp is not None and _div(d_in, dpn) else None,
                "model" if tp_ok and _div(d_out, tp) else None)

    if leafname in _ROW_TP and nd == 2:
        d_in, d_out = shape
        return ("model" if tp_ok and _div(d_in, tp) else None,
                dp if dp is not None and _div(d_out, dpn) else None)

    # default: FSDP on the first divisible dim
    for i, s in enumerate(shape):
        if dp is not None and _div(s, dpn):
            spec = [None] * nd
            spec[i] = dp
            return tuple(spec)
    return _spec(ndim=nd)


def shardable(cfg, mesh) -> tuple[bool, bool]:
    """(kv_shardable, heads_shardable) of ``cfg`` on ``mesh``'s TP axis."""
    kv_shardable = True
    heads_shardable = True
    if cfg is not None and cfg.attn is not None:
        tp = _axis_size(mesh, "model")
        heads_shardable = _div(cfg.attn.n_heads, tp)
        if cfg.attn_global is not None:
            heads_shardable &= _div(cfg.attn_global.n_heads, tp)
        if cfg.attn.mla is not None:
            kv_shardable = False            # latent cache is head-less
        else:
            kv_shardable = _div(cfg.attn.n_kv_heads, tp)
            if cfg.attn_global is not None:
                kv_shardable &= _div(cfg.attn_global.n_kv_heads, tp)
    return kv_shardable, heads_shardable


def param_specs(param_shapes, mesh, mode: str = "train", cfg=None):
    """Map a tree of tensors (or meta stand-ins) -> specs."""
    kv, heads = shardable(cfg, mesh)
    return pytree.tree_map_with_path(
        lambda path, leaf: param_spec(path, leaf, mesh, mode, kv, heads),
        param_shapes)


def param_shardings(param_shapes, mesh, mode: str = "train", cfg=None):
    """Map a tree of tensors (or meta stand-ins) -> DTensor placements."""
    return pytree.tree_map(lambda spec: to_placements(spec, mesh),
                           param_specs(param_shapes, mesh, mode, cfg),
                           is_leaf=lambda x: isinstance(x, tuple))


def to_placements(spec: tuple, mesh) -> tuple:
    """One placement per mesh dimension: ``Shard(d)`` where the axis splits
    tensor dimension ``d``, ``Replicate()`` elsewhere."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple)
                                     and name in entry)]
        if len(dims) > 1:
            raise ValueError(f"axis {name} splits dims {dims} of {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def distribute(tree, mesh, placements):
    """Place every tensor of ``tree`` on ``mesh`` by the matching entry of
    the ``placements`` tree (from :func:`param_shardings` and friends)."""
    leaves, spec = pytree.tree_flatten(tree)
    pls = pytree.tree_leaves(placements,
                             is_leaf=lambda x: isinstance(x, tuple))
    if len(pls) != len(leaves):
        raise ValueError(f"{len(leaves)} tensors, {len(pls)} placements")
    return pytree.tree_unflatten(
        [distribute_tensor(t, mesh, list(p)) for t, p in zip(leaves, pls)],
        spec)


def place_local(t, mesh, placements):
    """``t``, the same whole value on every rank, as a DTensor on
    ``placements`` with no communication: each rank keeps its own shard of
    its own copy.  A shard that is a view into ``t`` is copied out, so
    every shard owns its storage and dropping ``t`` frees the whole value
    (a fully replicated ``t`` is its own shard)."""
    d = distribute_tensor(t, mesh, list(placements), src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().nbytes() == local.numel() * \
            local.element_size():
        return d
    return DTensor.from_local(local.clone(), mesh, d.placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def batch_spec(mesh, ndim: int = 2) -> tuple:
    """Spec for [B, S, ...] activations/tokens: batch over (pod, data)."""
    return _spec(_dp_axes(mesh), ndim=ndim)


def batch_sharding(mesh, ndim: int = 2) -> tuple:
    return to_placements(batch_spec(mesh, ndim), mesh)


def cache_spec(mesh, batch: int, leafname: str, ndim: int) -> tuple:
    """KV/SSM cache spec for serving.

    - decode_32k (large batch): batch over (pod,data), heads over model.
    - long_500k (batch=1): sequence over data, heads over model (sequence
      parallelism — the KV cache is the dominant memory object).
    """
    dp = _dp_axes(mesh)
    dpn = _dp_size(mesh)
    if batch % max(dpn, 1) == 0 and batch >= dpn:
        if ndim >= 3:
            return (dp, None, "model") if ndim == 3 else \
                (dp, None, "model", None)
        return (dp, None)
    # batch too small: shard the sequence dim (axis 1) over data
    data_ax = "data" if "data" in mesh.mesh_dim_names else None
    if ndim == 4:
        return (None, data_ax, "model", None)
    if ndim == 3:
        return (None, data_ax, None)
    return (None, None)
