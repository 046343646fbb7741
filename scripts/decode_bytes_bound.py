#!/usr/bin/env python3
"""The bytes bound of one decode token of the served configurations.

A decode step (``models.transformer.decode_step``) reads every weight the
step touches once per token: every layer's, every expert of an MoE layer
(``moe_apply`` runs all of them on a batch of one token), the final norm,
the head (the embedding matrix when it is tied, else ``lm_head``) and one
row of the embedding per codebook (the token's lookup); the rest of an
untied embedding is not read, and the multi-token-prediction layer is
training only and is left out.  Its
cache is read too: the whole buffer ``decode_step`` masks
(``chip_smoke.py``'s serving length, 2000 prompt tokens, 16 new ones and
8 of slack, behind the prefix positions).  The bound is those bytes over
3.35 TB/s, the H100 SXM's published HBM rate; weights alone and weights
with the cache are printed.  Shapes only: the parameters are meta
tensors, and nothing runs on a device.

Run from the repository root (no card needed):

    python3 scripts/decode_bytes_bound.py

The configurations are those phases 10, 11, 19 and 20 of
``chip_smoke.py`` serve: yi-6b, mamba2-1.3b, deepseek-v3-671b cut to 4
layers, paligemma-3b.  The last line is one JSON object with every
number.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch.utils._pytree as pytree  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.roofline.flops_model import kv_cache_bytes  # noqa: E402


def decode_weight_bytes(cfg, batch: int = 1) -> int:
    """Bytes of the parameters a decode step of ``batch`` tokens reads:
    the layers, the final norm, the head's matrix and the looked-up rows
    of the embedding (not ``mtp``, not the rest of an untied
    embedding)."""
    shapes = param_shapes(cfg)
    shapes.pop("mtp", None)
    embed = shapes.pop("embed")
    head = shapes.pop("lm_head", embed)
    row = embed.shape[-1] * embed.element_size()
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(shapes)) + \
        head.numel() * head.element_size() + batch * cfg.codebooks * row


def main() -> int:
    cells = {"yi-6b": get_config("yi-6b"),
             "mamba2-1.3b": get_config("mamba2-1.3b"),
             "deepseek-v3-671b-4l": dataclasses.replace(
                 get_config("deepseek-v3-671b"), n_layers=4),
             "paligemma-3b": get_config("paligemma-3b")}
    out = {}
    for name, cfg in cells.items():
        weights = decode_weight_bytes(cfg)
        length = chip_smoke.PROMPT_LEN + chip_smoke.MAX_NEW + 8 + cfg.n_prefix
        cache = kv_cache_bytes(cfg, 1, length)
        out[name] = {
            "weight_bytes": weights, "cache_bytes": cache,
            "cache_positions": length,
            "weights_bound_ms": weights / chip_smoke.HBM_BYTES_PER_S * 1e3,
            "bound_ms": (weights + cache) / chip_smoke.HBM_BYTES_PER_S
            * 1e3}
        r = out[name]
        print(f"{name}: weights {weights / 1e9:.3f} GB -> "
              f"{r['weights_bound_ms']:.4f} ms; cache {cache / 1e9:.4f} GB "
              f"at {length} positions; bound a token {r['bound_ms']:.4f} ms "
              f"(bytes at 3.35 TB/s)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
