"""Analytical FLOP / memory model for the model stack, in pure Python on
the port's ``ModelConfig`` (the JAX package's formulas, unchanged).

Every matmul in the stack is counted exactly here; the count is held
against ``torch.utils.flop_counter.FlopCounterMode`` on a reduced forward
(tests/test_torch_roofline.py, within 15%).

Counts matmul FLOPs (2·m·n·k) only — elementwise/softmax/norm FLOPs are
O(activations) and <2% of totals at these dims.  Causal attention is
counted as the exact triangle (what the chunk-pair scan and the flash
kernel execute); windowed layers as the exact clipped sum.

Memory model: per-device HBM bytes per step = weight traffic (params read +
optimizer read/write for train) + activation traffic (layer I/O × remat
factor) + KV-cache traffic for decode.
"""
from __future__ import annotations

import torch.utils._pytree as pytree

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.transformer import ModelConfig, param_shapes


def _avg_causal_ctx(s: int, window: int | None = None) -> float:
    """Mean attended positions per query under causal (+window) masking."""
    if window is None or window >= s:
        return (s + 1) / 2
    w = window
    # positions 0..w-1 attend i+1; positions w..s-1 attend w
    return (w * (w + 1) / 2 + (s - w) * w) / s


def _attn_flops_per_token(cfg: ModelConfig, mixer: str, ctx: float) -> float:
    a = cfg.mixer_cfg(mixer)
    if a.mla is not None:
        m = a.mla
        h = a.n_heads
        proj = (2 * cfg.d_model * m.q_lora_rank
                + 2 * m.q_lora_rank * h * (m.nope_head_dim + m.rope_head_dim)
                + 2 * h * m.nope_head_dim * m.kv_lora_rank      # q absorb
                + 2 * cfg.d_model * (m.kv_lora_rank + m.rope_head_dim)
                + 2 * m.kv_lora_rank * h * m.v_head_dim          # out absorb
                + 2 * h * m.v_head_dim * cfg.d_model)
        attn = 2 * h * (m.kv_lora_rank + m.rope_head_dim) * ctx \
            + 2 * h * m.kv_lora_rank * ctx
        return proj + attn
    dh, hq, hkv = a.head_dim, a.n_heads, a.n_kv_heads
    proj = (2 * cfg.d_model * hq * dh + 4 * cfg.d_model * hkv * dh
            + 2 * hq * dh * cfg.d_model)
    attn = 4 * hq * dh * ctx
    return proj + attn


def _mamba_flops_per_token(cfg: ModelConfig) -> float:
    m = cfg.mamba
    di, g, n, h, p, l = (m.d_inner, m.n_groups, m.d_state, m.n_heads,
                         m.head_dim, m.chunk_size)
    proj = (4 * cfg.d_model * di          # w_z, w_x
            + 4 * cfg.d_model * g * n     # w_B, w_C
            + 2 * cfg.d_model * h)        # w_dt
    conv = 2 * m.d_conv * (di + 2 * g * n)
    # SSD per token per head: intra scores 2·l·N + intra pv 2·l·P +
    # states 2·N·P + inter 2·N·P
    ssd = h * (2 * l * n + 2 * l * p + 4 * n * p)
    out = 2 * di * cfg.d_model
    return proj + conv + ssd + out


def _ffn_flops_per_token(cfg: ModelConfig, ffn: str) -> float:
    if ffn == "none":
        return 0.0
    if ffn == "moe":
        mo = cfg.moe
        routed = mo.top_k * mo.capacity_factor * 6 * cfg.d_model * mo.d_ff_expert
        shared = 0.0
        if mo.n_shared_experts:
            fs = mo.d_ff_shared or mo.d_ff_expert * mo.n_shared_experts
            shared = 6 * cfg.d_model * fs
        router = 2 * cfg.d_model * mo.n_experts
        return routed + shared + router
    mult = 6 if cfg.gated_mlp else 4
    return mult * cfg.d_model * cfg.d_ff


def forward_flops_per_token(cfg: ModelConfig, seq_len: int,
                            decode: bool = False) -> float:
    """Forward FLOPs per processed token (decode: per generated token with a
    seq_len cache)."""
    total = 0.0
    layers = list(cfg.prelude) + list(cfg.pattern) * cfg.n_units
    for mixer, ffn in layers:
        if mixer == "mamba":
            total += _mamba_flops_per_token(cfg)
        else:
            a = cfg.mixer_cfg(mixer)
            ctx = (min(a.window or seq_len, seq_len) if decode
                   else _avg_causal_ctx(seq_len, a.window))
            total += _attn_flops_per_token(cfg, mixer, ctx)
        total += _ffn_flops_per_token(cfg, ffn)
    # logits
    total += 2 * cfg.d_model * cfg.vocab * cfg.codebooks
    if cfg.mtp and not decode:
        mixer, ffn = cfg.pattern[-1]
        a = cfg.mixer_cfg(mixer)
        total += (2 * 2 * cfg.d_model * cfg.d_model
                  + _attn_flops_per_token(cfg, mixer,
                                          _avg_causal_ctx(seq_len, a.window))
                  + _ffn_flops_per_token(cfg, ffn)
                  + 2 * cfg.d_model * cfg.vocab)
    return total


TRAIN_FACTOR = 3.0       # fwd + bwd(2×); remat recompute adds ~1 more fwd
TRAIN_FACTOR_REMAT = 4.0


def cell_flops(cfg: ModelConfig, shape: ShapeSpec, n_devices: int,
               remat: bool = True) -> dict[str, float]:
    """Global and per-device FLOPs for one (arch × shape) cell."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        f = forward_flops_per_token(cfg, shape.seq_len)
        factor = TRAIN_FACTOR_REMAT if remat else TRAIN_FACTOR
        total = f * tokens * factor
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = forward_flops_per_token(cfg, shape.seq_len) * tokens
    else:
        tokens = shape.global_batch
        total = forward_flops_per_token(cfg, shape.seq_len,
                                        decode=True) * tokens
    return {"global": total, "per_device": total / n_devices}


# ---------------------------------------------------------------------------
# memory traffic model (per device, per step)
# ---------------------------------------------------------------------------

def param_bytes(cfg: ModelConfig) -> float:
    return float(sum(x.numel() * x.element_size()
                     for x in pytree.tree_leaves(param_shapes(cfg))))


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq_len: int,
                   window_caches: bool = False) -> float:
    total = 0.0
    layers = list(cfg.prelude) + list(cfg.pattern) * cfg.n_units
    for mixer, _ in layers:
        if mixer == "mamba":
            m = cfg.mamba
            total += batch * m.n_heads * m.d_state * m.head_dim * 4
            total += batch * (m.d_conv - 1) * (m.d_inner
                                               + 2 * m.n_groups * m.d_state) * 2
        else:
            a = cfg.mixer_cfg(mixer)
            if a.mla is not None:
                total += batch * seq_len * (a.mla.kv_lora_rank
                                            + a.mla.rope_head_dim) * 2
            else:
                s_eff = seq_len
                if window_caches and a.window is not None:
                    s_eff = min(seq_len, a.window)
                total += batch * s_eff * a.n_kv_heads * a.head_dim * 2 * 2
    return total


def cell_hbm_bytes(cfg: ModelConfig, shape: ShapeSpec,
                   n_devices: int, window_caches: bool = False) -> dict[str, float]:
    """Per-device HBM traffic per step (model; documented assumptions)."""
    pb = param_bytes(cfg) / n_devices
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill") else shape.global_batch)
    n_layers = cfg.n_layers
    # activation I/O: ~12 intermediate tensors of [tokens, d_model] per layer
    act = 12 * tokens * cfg.d_model * 2 * n_layers / n_devices
    if shape.kind == "train":
        # params read (fwd+bwd+recompute ≈ 3×) + grads w + opt m/v r/w (fp32)
        weight_traffic = 3 * pb + 2 * pb + 4 * (pb / 2) * 4
        act *= 2.5          # bwd + remat recompute
        total = weight_traffic + act
    elif shape.kind == "prefill":
        total = pb + act + kv_cache_bytes(cfg, shape.global_batch,
                                          shape.seq_len,
                                          window_caches) / n_devices
    else:
        total = pb + kv_cache_bytes(cfg, shape.global_batch, shape.seq_len,
                                    window_caches) / n_devices + act
    return {"per_device": total}
