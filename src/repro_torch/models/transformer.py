"""Decoder stack: embedding, prelude + repeated unit of layers, final norm
and head; the training forward and loss, prefill and one-token decode.

A model is a *prelude* (irregular leading layers) followed by ``n_units``
repetitions of a *pattern* (a tuple of ``LayerSpec``):

- gemma3:  6-layer unit  5×(attn_local, dense) + 1×(attn_global, dense)
- mamba2:  unit (mamba, none)

Unit parameters are a list over units of lists over the pattern (the JAX
package stacks them on a leading axis for ``lax.scan``; here the units are
a Python loop, so there is no ``scan_units``).  Each unit of the training
forward is rematerialised in the backward as ``ModelConfig.remat`` says,
through ``torch.utils.checkpoint``.  MoE layers and MLA attention are not
ported yet and raise; so the aux loss is always zero, and DeepSeek's MTP
head and the multimodal stubs (prefix embeddings, MusicGen's codebooks)
belong to the MoE/multimodal slice.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models.attention import (AttentionConfig, gqa_decode,
                                          gqa_forward, gqa_prefill,
                                          make_attention_params)
from repro_torch.models.layers import (DEFAULT_DTYPE, cross_entropy_loss,
                                       embed_init, make_mlp_params, mlp_apply,
                                       norm_init, rmsnorm)
from repro_torch.models.mamba import (MambaConfig, make_mamba_params,
                                      mamba_decode, mamba_forward,
                                      mamba_prefill)

LayerSpec = tuple[str, str]          # (mixer, ffn)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    vocab: int
    pattern: tuple[LayerSpec, ...]
    prelude: tuple[LayerSpec, ...] = ()
    attn: AttentionConfig | None = None
    attn_global: AttentionConfig | None = None   # for attn_global mixer
    mamba: MambaConfig | None = None
    d_ff: int = 0
    gated_mlp: bool = True
    tie_embeddings: bool = True
    aux_loss_weight: float = 0.01
    dtype: torch.dtype = DEFAULT_DTYPE
    remat: str = "nothing_saveable"   # "none" | "nothing_saveable" | "dots"

    @property
    def n_units(self) -> int:
        body = self.n_layers - len(self.prelude)
        if body % len(self.pattern):
            raise ValueError(f"{self.name}: {body} layers not divisible by "
                             f"unit {len(self.pattern)}")
        return body // len(self.pattern)

    def mixer_cfg(self, mixer: str) -> AttentionConfig:
        if mixer == "attn_global" and self.attn_global is not None:
            return self.attn_global
        return self.attn


def _check_ported(spec: LayerSpec) -> None:
    mixer, ffn = spec
    if mixer == "mla" or ffn == "moe":
        raise NotImplementedError(f"layer {spec}: MLA and MoE are not ported "
                                  f"to repro_torch yet (MoE/MLA slice)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _make_layer_params(gen: torch.Generator, cfg: ModelConfig,
                       spec: LayerSpec) -> dict:
    _check_ported(spec)
    mixer, ffn = spec
    p: dict[str, Any] = {"norm1": norm_init(cfg.d_model, gen.device)}
    if mixer == "mamba":
        p["mixer"] = make_mamba_params(gen, cfg.mamba, cfg.dtype)
    else:
        p["mixer"] = make_attention_params(gen, cfg.mixer_cfg(mixer),
                                           cfg.dtype)
    if ffn != "none":
        p["norm2"] = norm_init(cfg.d_model, gen.device)
        p["mlp"] = make_mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                                   cfg.dtype)
    return p


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None):
    """Random parameters drawn from ``generator`` (on its device), placed on
    ``device`` (CUDA by default)."""
    device = resolve_device(device)
    gen = generator
    params: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype),
        "final_norm": norm_init(cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab, cfg.d_model,
                                       cfg.dtype)
    params["prelude"] = [_make_layer_params(gen, cfg, s)
                         for s in cfg.prelude]
    params["units"] = [[_make_layer_params(gen, cfg, s) for s in cfg.pattern]
                       for _ in range(cfg.n_units)]
    return _to(params, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# embedding and head
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens):
    """tokens: [B,S] ids.  Returns [B,S,D]."""
    return params["embed"][tokens]


def logits_fn(params, cfg: ModelConfig, x):
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return x @ head.T


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def _layer_forward(p, cfg: ModelConfig, spec: LayerSpec, x, positions):
    _check_ported(spec)
    mixer, ffn = spec
    h = rmsnorm(x, p["norm1"])
    if mixer == "mamba":
        h = mamba_forward(p["mixer"], cfg.mamba, h)
    else:
        h = gqa_forward(p["mixer"], cfg.mixer_cfg(mixer), h, positions)
    x = x + h
    if ffn != "none":
        x = x + mlp_apply(p["mlp"], rmsnorm(x, p["norm2"]))
    return x


def _unit_forward(unit_params, cfg: ModelConfig, x, positions):
    for p, spec in zip(unit_params, cfg.pattern):
        x = _layer_forward(p, cfg, spec, x, positions)
    return x


# the products whose outputs the "dots" policy keeps for the backward
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, cfg: ModelConfig):
    """``fn`` recomputed in the backward: nothing saved
    (``"nothing_saveable"``) or the matmul outputs saved (``"dots"``)."""
    if cfg.remat == "none":
        return fn
    kwargs = {"use_reentrant": False}
    if cfg.remat == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, **kwargs)


def forward(params, cfg: ModelConfig, tokens):
    """Full forward -> (logits [B,S,V], aux loss, final hidden [B,S,D]).
    The aux (load-balancing) loss comes from MoE layers, not ported yet:
    it is zero."""
    x = embed_tokens(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for p, spec in zip(params["prelude"], cfg.prelude):
        x = _layer_forward(p, cfg, spec, x, positions)
    unit_fn = _remat_wrap(
        lambda up, xx: _unit_forward(up, cfg, xx, positions), cfg)
    for up in params["units"]:
        x = unit_fn(up, x)
    x = rmsnorm(x, params["final_norm"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits_fn(params, cfg, x), aux, x


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: {"tokens": [B,S], "labels": [B,S]} -> (total, metrics)."""
    logits, aux, _ = forward(params, cfg, batch["tokens"])
    loss = cross_entropy_loss(logits, batch["labels"])
    total = loss + cfg.aux_loss_weight * aux
    return total, {"loss": loss, "aux": aux}


def param_count(params) -> int:
    return sum(t.numel() for t in pytree.tree_leaves(params))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _layer_prefill(p, cfg: ModelConfig, spec: LayerSpec, x, positions):
    _check_ported(spec)
    mixer, ffn = spec
    h = rmsnorm(x, p["norm1"])
    if mixer == "mamba":
        h, cache = mamba_prefill(p["mixer"], cfg.mamba, h)
    else:
        h, cache = gqa_prefill(p["mixer"], cfg.mixer_cfg(mixer), h, positions)
    x = x + h
    if ffn != "none":
        x = x + mlp_apply(p["mlp"], rmsnorm(x, p["norm2"]))
    return x, cache


def _pad_cache(cache, max_len: int):
    """Grow attention caches from prefill length to max_len (decode room)."""
    out = {}
    for k, v in cache.items():
        if k in ("k", "v", "c", "k_rope"):
            pad = [0, 0] * (v.dim() - 2) + [0, max_len - v.shape[1]]
            out[k] = F.pad(v, pad)
        else:
            out[k] = v
    return out


def prefill(params, cfg: ModelConfig, tokens, max_len: int | None = None):
    """Run the prompt; returns (last_logits [B,V], caches, length)."""
    x = embed_tokens(params, tokens)
    s = x.shape[1]
    max_len = max_len or s + 1
    positions = torch.arange(s, device=x.device)
    caches: dict[str, Any] = {"prelude": [], "units": []}
    for p, spec in zip(params["prelude"], cfg.prelude):
        x, cache = _layer_prefill(p, cfg, spec, x, positions)
        caches["prelude"].append(_pad_cache(cache, max_len))
    for up in params["units"]:
        unit_caches = []
        for p, spec in zip(up, cfg.pattern):
            x, cache = _layer_prefill(p, cfg, spec, x, positions)
            unit_caches.append(_pad_cache(cache, max_len))
        caches["units"].append(unit_caches)
    x = rmsnorm(x, params["final_norm"])
    logits = logits_fn(params, cfg, x[:, -1:])[:, 0]
    return logits, caches, s


def _layer_decode(p, cfg: ModelConfig, spec: LayerSpec, x, cache,
                  cache_len: int):
    mixer, ffn = spec
    h = rmsnorm(x, p["norm1"])
    if mixer == "mamba":
        h, cache = mamba_decode(p["mixer"], cfg.mamba, h, cache)
    else:
        h, cache = gqa_decode(p["mixer"], cfg.mixer_cfg(mixer), h, cache,
                              cache_len)
    x = x + h
    if ffn != "none":
        x = x + mlp_apply(p["mlp"], rmsnorm(x, p["norm2"]))
    return x, cache


def decode_step(params, cfg: ModelConfig, token, caches, cache_len: int):
    """One decode step.  token: [B]; caches from prefill; cache_len:
    current length.  Returns (logits, new caches); attention caches are
    updated in place."""
    x = embed_tokens(params, token)[:, None, :]
    new_caches: dict[str, Any] = {"prelude": [], "units": []}
    for p, spec, cache in zip(params["prelude"], cfg.prelude,
                              caches["prelude"]):
        x, cache = _layer_decode(p, cfg, spec, x, cache, cache_len)
        new_caches["prelude"].append(cache)
    for up, unit_cache in zip(params["units"], caches["units"]):
        new_unit = []
        for p, spec, cache in zip(up, cfg.pattern, unit_cache):
            x, cache = _layer_decode(p, cfg, spec, x, cache, cache_len)
            new_unit.append(cache)
        new_caches["units"].append(new_unit)
    x = rmsnorm(x, params["final_norm"])
    logits = logits_fn(params, cfg, x)[:, 0]
    return logits, new_caches
