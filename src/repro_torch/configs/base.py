"""Config registry: full (published-width) and reduced (smoke) configs per
architecture, plus the shape grid.

Every entry cites its source and matches the JAX package's numbers.
``reduced`` configs shrink layers/width/vocab for CPU tests while keeping
the family (same pattern, same mixer types).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models.transformer import ModelConfig

# ---------------------------------------------------------------------------
# shape grid (LM family): seq_len × global_batch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs that may run long_500k (sub-quadratic / windowed / SSM decode);
# pure full-attention archs skip it
LONG_CONTEXT_ARCHS = {"mamba2-1.3b", "jamba-1.5-large-398b", "gemma3-27b"}

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def register_reduced(name: str):
    def deco(fn):
        _REDUCED[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    return _REGISTRY[name]()


def get_reduced_config(name: str) -> ModelConfig:
    return _REDUCED[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells, honoring long-context applicability."""
    out = []
    for arch in list_archs():
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            out.append((arch, shape))
    return out
