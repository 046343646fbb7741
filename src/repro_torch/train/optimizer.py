"""AdamW with float32 or bfloat16 moments.

Pure-functional, as in the JAX package: ``adamw_init(params) -> state``,
``adamw_update(grads, state, params) -> (new_params, new_state, gnorm)``;
parameters and states are nested dicts and lists of tensors.  The update
runs tensor by tensor in float32 and casts the result back to the
parameter's dtype and the moments to ``moment_dtype`` (bfloat16 moments
halve the optimizer's memory).

Weight decay follows the JAX package's rule, which decays tensors of ndim
>= 2 in its layout.  There the unit parameters are stacked on a leading
axis, so a tensor under ``params["units"]`` counts one dimension more than
it has in the port's list of units: its norm scales, ``A_log``, ``D`` and
biases decay, the prelude's and ``final_norm`` do not.

On a mesh every tensor is a DTensor and the update runs shard by shard;
the global norm is a sum over every shard of every tensor.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor


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
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in pytree.tree_leaves(tree)))


def _decays(path, p: torch.Tensor) -> bool:
    """Decoupled weight decay on matrices of the stacked layout only."""
    stacked = bool(path) and getattr(path[0], "key", None) == "units"
    return p.dim() + stacked >= 2


def adamw_update(grads, state, params, cfg: AdamWConfig):
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    t = step.float()
    c1 = 1 - cfg.b1 ** t
    c2 = 1 - cfg.b2 ** t

    def upd(g, m, v, p, decay):
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.float() * cfg.b2 + g * g * (1 - cfg.b2)
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - cfg.lr * delta).to(p.dtype)
        return new_p, m32.to(m.dtype), v32.to(v.dtype)

    leaves, spec = pytree.tree_flatten_with_path(params)
    out = [upd(g, m, v, p, _decays(path, p))
           for g, m, v, (path, p) in zip(pytree.tree_leaves(grads),
                                         pytree.tree_leaves(state["m"]),
                                         pytree.tree_leaves(state["v"]),
                                         leaves)]
    new_params, new_m, new_v = (
        pytree.tree_unflatten([t[i] for t in out], spec) for i in range(3))
    return new_params, {"m": new_m, "v": new_v, "step": step}, gnorm
