"""Meta-device stand-ins and shardings for every model input — the dry
run's contract: the shapes and dtypes of the JAX package's
``ShapeDtypeStruct`` stand-ins, as ``torch.empty(..., device="meta")``
tensors (nothing is allocated).

Caches mirror the port's ``prefill`` output: ``units`` is a list over
units of lists over the pattern, where the JAX package stacks each
pattern position's caches on a leading ``[n_units]`` axis.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.shardings import (_axis_size, _dp_axes, _dp_size,
                                          to_placements)
from repro_torch.models.transformer import ModelConfig


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    tok_shape = (b, s, cfg.codebooks) if cfg.codebooks > 1 else (b, s)
    specs = {
        "tokens": _sds(tok_shape, torch.int32),
        "labels": _sds(tok_shape, torch.int32),
    }
    if cfg.n_prefix:
        specs["prefix_embeddings"] = _sds((b, cfg.n_prefix, cfg.d_model),
                                          torch.bfloat16)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: ShapeSpec):
    b, s = shape.global_batch, shape.seq_len
    tok_shape = (b, s, cfg.codebooks) if cfg.codebooks > 1 else (b, s)
    specs = {"tokens": _sds(tok_shape, torch.int32)}
    if cfg.n_prefix:
        specs["prefix_embeddings"] = _sds((b, cfg.n_prefix, cfg.d_model),
                                          torch.bfloat16)
    return specs


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def _layer_cache_spec(cfg: ModelConfig, spec, batch: int, max_len: int,
                      window_caches: bool = False):
    mixer, _ = spec
    if mixer == "mamba":
        m = cfg.mamba
        return {
            "ssm": _sds((batch, m.n_heads, m.d_state, m.head_dim),
                        torch.float32),
            "conv": {
                "x": _sds((batch, m.d_conv - 1, m.d_inner), cfg.dtype),
                "B": _sds((batch, m.d_conv - 1, m.n_groups * m.d_state),
                          cfg.dtype),
                "C": _sds((batch, m.d_conv - 1, m.n_groups * m.d_state),
                          cfg.dtype),
            },
        }
    acfg = cfg.mixer_cfg(mixer)
    if window_caches and acfg.mla is None and acfg.window is not None:
        max_len = min(max_len, acfg.window)
    if acfg.mla is not None:
        m = acfg.mla
        return {
            "c": _sds((batch, max_len, m.kv_lora_rank), cfg.dtype),
            "k_rope": _sds((batch, max_len, m.rope_head_dim), cfg.dtype),
        }
    return {
        "k": _sds((batch, max_len, acfg.n_kv_heads, acfg.head_dim),
                  cfg.dtype),
        "v": _sds((batch, max_len, acfg.n_kv_heads, acfg.head_dim),
                  cfg.dtype),
    }


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                window_caches: bool = False):
    """Cache tree (meta tensors) mirroring ``prefill``'s output.
    ``window_caches``: ring caches of size min(max_len, window) for
    sliding-window layers."""
    return {
        "prelude": [_layer_cache_spec(cfg, s, batch, max_len, window_caches)
                    for s in cfg.prelude],
        "units": [[_layer_cache_spec(cfg, s, batch, max_len, window_caches)
                   for s in cfg.pattern] for _ in range(cfg.n_units)],
    }


def cache_leaf_spec(leafname: str, shape, mesh, batch: int) -> tuple:
    """Per-leaf cache spec: KV seq over data when batch is tiny
    (long-context sequence parallelism), batch over (pod,data) otherwise;
    heads/state over model."""
    dp = _dp_axes(mesh)
    dpn = _dp_size(mesh)
    tp = _axis_size(mesh, "model")
    big_batch = batch % max(dpn, 1) == 0 and batch >= dpn

    def head_ax(size):
        return "model" if size % tp == 0 else None

    if leafname in ("k", "v"):                       # [B, S, H, D]
        if big_batch:
            return (dp, None, head_ax(shape[2]), None)
        return (None, "data", head_ax(shape[2]), None)
    if leafname in ("c", "k_rope"):                  # [B, S, dc]
        if big_batch:
            return (dp, None, None)
        return (None, "data", None)
    if leafname == "ssm":                            # [B, H, N, P]
        return (dp if big_batch else None, head_ax(shape[1]), None, None)
    if leafname in ("x", "B", "C"):                  # conv [B, K-1, C]
        return (dp if big_batch else None, None,
                "model" if shape[2] % tp == 0 else None)
    return (None,) * len(shape)


def _leafname(path) -> str:
    names = [str(getattr(k, "key", getattr(k, "name", ""))) for k in path]
    return names[-1] if names else ""


def cache_leaf_specs(cfg: ModelConfig, batch: int, max_len: int, mesh,
                     window_caches: bool = False):
    """The spec of every leaf of :func:`cache_specs`."""
    return pytree.tree_map_with_path(
        lambda p, leaf: cache_leaf_spec(_leafname(p), leaf.shape, mesh,
                                        batch),
        cache_specs(cfg, batch, max_len, window_caches))


def cache_shardings(cfg: ModelConfig, batch: int, max_len: int, mesh,
                    window_caches: bool = False):
    return pytree.tree_map(
        lambda spec: to_placements(spec, mesh),
        cache_leaf_specs(cfg, batch, max_len, mesh, window_caches),
        is_leaf=lambda x: isinstance(x, tuple))


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec,
                       window_caches: bool = False):
    """Inputs for one decode step: one new token + caches at seq_len."""
    b, s = shape.global_batch, shape.seq_len
    tok_shape = (b, cfg.codebooks) if cfg.codebooks > 1 else (b,)
    return {
        "token": _sds(tok_shape, torch.int32),
        "caches": cache_specs(cfg, b, s, window_caches),
        "cache_len": _sds((), torch.int32),
    }


def token_spec(cfg: ModelConfig, batch: int, mesh) -> tuple:
    dpn = _dp_size(mesh)
    dp = _dp_axes(mesh)
    if batch % max(dpn, 1) == 0 and batch >= dpn:
        return (dp, None) if cfg.codebooks > 1 else (dp,)
    return (None,) * (2 if cfg.codebooks > 1 else 1)


def token_sharding(cfg: ModelConfig, batch: int, mesh) -> tuple:
    return to_placements(token_spec(cfg, batch, mesh), mesh)
