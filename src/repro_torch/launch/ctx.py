"""Sharding-hint context: lets launch-layer code pin intermediate shardings
inside otherwise mesh-agnostic model code.

Model code calls ``constrain(x, "kv_cache")``; when the launcher has
installed a hint for that name (a spec: one entry per tensor dimension,
an axis name, a tuple of axis names or ``None``; or a callable that takes
the tensor and returns such a spec), a DTensor is redistributed to it.
Otherwise, and always on a plain tensor, it is a no-op, so tests and
single-device runs are unaffected.

The JAX package pins decode caches this way so that the compiler does not
re-shard them every step.  Here nothing moves unless asked, so the hint
states the cache layout the decode keeps.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any

from torch.distributed.tensor import DTensor

_HINTS: contextvars.ContextVar[dict[str, Any] | None] = \
    contextvars.ContextVar("sharding_hints", default=None)


@contextlib.contextmanager
def sharding_hints(**hints: Any):
    token = _HINTS.set(dict(hints))
    try:
        yield
    finally:
        _HINTS.reset(token)


def constrain(x, name: str):
    if not isinstance(x, DTensor):
        return x
    hints = _HINTS.get()
    if not hints:
        return x
    spec = hints.get(name)
    if spec is None:
        return x
    if callable(spec):                    # shape-aware hint
        spec = spec(x)
    if spec is None:
        return x
    from repro_torch.launch.shardings import to_placements
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def get_hint(name: str):
    """Raw hint lookup (non-sharding payloads, e.g. the mesh for the
    expert-parallel MoE path)."""
    hints = _HINTS.get()
    return hints.get(name) if hints else None
