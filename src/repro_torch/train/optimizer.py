"""AdamW with float32 or bfloat16 moments.

As in the JAX package, ``adamw_init(params) -> state`` and
``adamw_update(grads, state, params) -> (new_params, new_state, gnorm)``;
besides, ``adamw_update_(grads, state, params) -> gnorm`` updates in
place.  Parameters and states are nested dicts and lists of tensors.  The
update computes in float32 and casts the result back to the parameter's
dtype and the moments to ``moment_dtype`` (bfloat16 moments halve the
optimizer's memory).

Weight decay follows the JAX package's rule, which decays tensors of ndim
>= 2 in its layout.  There the unit parameters are stacked on a leading
axis, so a tensor under ``params["units"]`` counts one dimension more than
it has in the port's list of units: its norm scales, ``A_log``, ``D`` and
biases decay, the prelude's and ``final_norm`` do not.

Both updates skip a step whose gradient norm, or loss where one is given,
is not finite: the parameters, moments and step count stay as they were
(the JAX package's train step does this with ``jnp.where`` after its
update).  On plain tensors they go through ``kernels/adamw.py``: on the
card the hand-written kernel (K5), on the CPU its plain version.
``adamw_update_`` writes the new parameters and moments over the old
ones, so a train step holds one copy of its state (what the JAX package's
``donate_argnums`` buys); ``adamw_update`` keeps the JAX package's
functional signature and returns new tensors.

On a mesh every tensor is a DTensor, and both updates run K5 on each
rank's local shards (``to_local()``): ``adamw_update_`` writes them in
place, so a mesh step too holds one copy of its state (the JAX package's
``donate_argnums`` under ``in_shardings``); ``adamw_update`` writes new
shards and returns them as DTensors of the same placements.  The norm is
the whole gradient's: each rank sums the squares of its shards, a shard
replicated over a mesh dimension only on the ranks at coordinate 0 of
that dimension (so every element counts once), and K5 all-reduces that
sum between its norm pass and its finish.  The skip decision reads the
whole loss (``full_tensor()``) and the global norm, so every rank takes
the same one.  A gradient of another placement than its parameter's
(``Partial`` among them) raises.  K5's plain version on DTensors
(``adamw_step_plain_`` given them whole) stays an oracle for tests.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.kernels import adamw as K5


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments placed like the parameters (DTensors on a mesh, made
    shard by shard: no rank holds a whole moment); the step count
    replicated beside them."""
    def zeros_like(p):
        return torch.zeros_like(p, dtype=cfg.moment_dtype)
    first = pytree.tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if isinstance(first, DTensor):
        mesh = first.device_mesh
        step = distribute_tensor(step, mesh, [Replicate()] * mesh.ndim)
    return {
        "m": pytree.tree_map(zeros_like, params),
        "v": pytree.tree_map(zeros_like, params),
        "step": step,
    }


def global_norm(tree) -> torch.Tensor:
    return K5.grad_norm(pytree.tree_leaves(tree))


def _decays(path, p: torch.Tensor) -> bool:
    """Decoupled weight decay on matrices of the stacked layout only."""
    stacked = bool(path) and getattr(path[0], "key", None) == "units"
    return p.dim() + stacked >= 2


def _flat(grads, state, params):
    """Leaves of gradients, parameters and moments in one order, and each
    parameter's decay flag."""
    leaves, spec = pytree.tree_flatten_with_path(params)
    return (pytree.tree_leaves(grads), [p for _, p in leaves],
            pytree.tree_leaves(state["m"]), pytree.tree_leaves(state["v"]),
            [_decays(path, p) for path, p in leaves], spec)


def _hyper(cfg: AdamWConfig) -> dict:
    return {"lr": cfg.lr, "b1": cfg.b1, "b2": cfg.b2, "eps": cfg.eps,
            "weight_decay": cfg.weight_decay, "grad_clip": cfg.grad_clip}


def norm_groups(mesh) -> list:
    """The process groups over which a rank's norm partial is summed: the
    default group where the mesh spans the world (one all-reduce), else
    each mesh dimension's in turn."""
    if mesh.size() == dist.get_world_size():
        return [None]
    return [mesh.get_group(d) for d in range(mesh.ndim)]


def _local_shards(gs, ps, ms, vs, step, loss):
    """What K5 takes: plain tensors as they are; for DTensors their local
    shards, the local step, the whole loss, and K5's mesh arguments (each
    local tensor's norm flag and the norm's groups, :func:`norm_groups`)."""
    if not isinstance(ps[0], DTensor):
        return gs, ps, ms, vs, step, loss, {}
    mesh = ps[0].device_mesh
    counted = []
    for i, p in enumerate(ps):
        for name, t in (("gradient", gs[i]), ("first moment", ms[i]),
                        ("second moment", vs[i])):
            if not isinstance(t, DTensor) or t.device_mesh != mesh \
                    or t.placements != p.placements:
                raise ValueError(
                    f"adamw on a mesh: tensor {i}'s {name} is not placed as "
                    f"its parameter ({p.placements})")
        if any(pl.is_partial() for pl in p.placements):
            raise ValueError(f"adamw on a mesh: tensor {i} is Partial; "
                             f"reduce its gradient first")
        counted.append(all(mesh.get_local_rank(d) == 0
                           for d, pl in enumerate(p.placements)
                           if pl.is_replicate()))
    if isinstance(loss, DTensor):
        loss = loss.full_tensor()
    return ([g.to_local().contiguous() for g in gs],
            [t.to_local() for t in ps], [t.to_local() for t in ms],
            [t.to_local() for t in vs], step.to_local(), loss,
            {"counted": counted, "groups": norm_groups(mesh)})


def _update(ps):
    """K5's wrapper, or for meta tensors (the dry run: shapes without data,
    where no kernel runs) K5's plain version, which the wrapper refuses."""
    return K5.adamw_step_plain_ if ps[0].device.type == "meta" \
        else K5.adamw_step_


def adamw_update_(grads, state, params, cfg: AdamWConfig, loss=None):
    """Update ``params`` and ``state`` (``m``, ``v``, ``step``) in place
    from ``grads``; returns the global gradient norm.  On the card one K5
    call (on a mesh over each rank's local shards), on the CPU its plain
    version."""
    gs, ps, ms, vs, decays, _ = _flat(grads, state, params)
    gs, ps, ms, vs, step, loss, mesh = _local_shards(gs, ps, ms, vs,
                                                     state["step"], loss)
    return _update(ps)(gs, ps, ms, vs, step, decays, loss=loss, **mesh,
                       **_hyper(cfg))


def adamw_update(grads, state, params, cfg: AdamWConfig, loss=None):
    """``(new_params, new_state, gnorm)``, the inputs left as they were:
    K5 out of place (its plain version on the CPU), on a mesh over each
    rank's local shards into new DTensors of the same placements."""
    gs, ps, ms, vs, decays, spec = _flat(grads, state, params)
    like = (ps, ms, vs, state["step"])
    gs, ps, ms, vs, step, loss, mesh = _local_shards(gs, ps, ms, vs,
                                                     state["step"], loss)
    out = ([torch.empty_like(p) for p in ps],
           [torch.empty_like(m) for m in ms],
           [torch.empty_like(v) for v in vs],
           torch.empty_like(step))
    gnorm = _update(ps)(gs, ps, ms, vs, step, decays, loss=loss, out=out,
                        **mesh, **_hyper(cfg))
    if mesh:
        def wrap(local, d):
            return DTensor.from_local(local, d.device_mesh, d.placements,
                                      run_check=False, shape=d.shape,
                                      stride=d.stride())
        out = tuple([wrap(t, d) for t, d in zip(o, ds)]
                    for o, ds in zip(out[:3], like[:3])) \
            + (wrap(out[3], like[3]),)
    return (pytree.tree_unflatten(out[0], spec),
            {"m": pytree.tree_unflatten(out[1], spec),
             "v": pytree.tree_unflatten(out[2], spec), "step": out[3]},
            gnorm)
