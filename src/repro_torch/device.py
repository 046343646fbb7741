"""Device selection shared by the port's entry points.

Every entry point that can place work on an accelerator (``run_strategy``,
``make_prefetcher``, ``ARIMA``, ``PlacementEngine``, ``kmeans``) takes an
explicit ``device``.  ``None`` means the card: the port is written for one
CUDA device, and a caller that wants the CPU (the tests) says so.  Asking
for CUDA where there is none raises instead of silently running elsewhere.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch paths")
    return dev
