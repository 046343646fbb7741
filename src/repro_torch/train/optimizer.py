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

On a mesh every tensor is a DTensor and ``adamw_update`` runs K5's plain
version on them, shard by shard; the global norm is a sum over every
shard of every tensor.  The kernel takes no DTensor, and
``adamw_update_`` refuses one.
"""
from __future__ import annotations

import dataclasses

import torch
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
    """Zero moments placed like the parameters (DTensors on a mesh); the
    step count replicated beside them."""
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


def adamw_update_(grads, state, params, cfg: AdamWConfig, loss=None):
    """Update ``params`` and ``state`` (``m``, ``v``, ``step``) in place
    from ``grads``; returns the global gradient norm.  Plain tensors only:
    on the card one K5 call, on the CPU its plain version."""
    gs, ps, ms, vs, decays, _ = _flat(grads, state, params)
    if isinstance(ps[0], DTensor):
        raise TypeError("adamw_update_ takes plain tensors; a mesh step "
                        "uses adamw_update")
    return K5.adamw_step_(gs, ps, ms, vs, state["step"], decays, loss=loss,
                          **_hyper(cfg))


def adamw_update(grads, state, params, cfg: AdamWConfig, loss=None):
    """``(new_params, new_state, gnorm)``, the inputs left as they were.
    Plain tensors go through K5 out of place (its plain version on the
    CPU); DTensors through the plain version, shard by shard."""
    gs, ps, ms, vs, decays, spec = _flat(grads, state, params)
    out = ([torch.empty_like(p) for p in ps],
           [torch.empty_like(m) for m in ms],
           [torch.empty_like(v) for v in vs],
           torch.empty_like(state["step"]))
    update = K5.adamw_step_plain_ if isinstance(ps[0], DTensor) \
        else K5.adamw_step_
    gnorm = update(gs, ps, ms, vs, state["step"], decays, loss=loss, out=out,
                   **_hyper(cfg))
    return (pytree.tree_unflatten(out[0], spec),
            {"m": pytree.tree_unflatten(out[1], spec),
             "v": pytree.tree_unflatten(out[2], spec), "step": out[3]},
            gnorm)
