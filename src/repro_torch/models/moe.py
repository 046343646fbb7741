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

The JAX package's expert-parallel ``shard_map`` path belongs to the
distributed slice; this is its single-device path.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

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


def moe_apply(params, cfg: MoEConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE layer.  x: [B, S, D].  Returns (out, aux_loss)."""
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

    # expert MLPs, batched over the expert axis
    g = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    h = F.silu(g.float()).to(buf.dtype) * u
    ye = torch.bmm(h, params["w_down"])                    # [E, C, D]

    # combine: gather back and mix with gate values
    gathered = ye[flat_e, pos_c]                           # [T*k, D]
    gates = (top_vals.reshape(t * k) * keep).to(gathered.dtype)
    out = torch.sum((gathered * gates[:, None]).reshape(t, k, d), dim=1)

    # load-balance auxiliary loss (Switch):  E · Σ_e f_e · p_e
    me = counts.float() / (t * k)
    pe = torch.mean(scores, dim=0)
    aux = e * torch.sum(me * pe)

    if cfg.n_shared_experts and "shared" in params:
        sh = params["shared"]
        g = xt @ sh["w_gate"]
        u = xt @ sh["w_up"]
        hs = F.silu(g.float()).to(xt.dtype) * u
        out = out + hs @ sh["w_down"]

    return out.reshape(b, s, d).to(x.dtype), aux.float()
