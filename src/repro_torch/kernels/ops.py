"""The models' entry to the attention and SSD kernels.

On a CUDA tensor these launch the hand-written kernels (K2
:mod:`repro_torch.kernels.flash_attention`, K3
:mod:`repro_torch.kernels.ssd_scan`) on the route each kernel's ``route``
names from the shape and type: every head dim up to 256 for K2 and every
N, P whose state fits a block's shared memory for K3, so the reduced
configs run on the card too.  A CUDA input outside every route raises; it
never drops to another path.  On a CPU tensor they run the
models' own chunked PyTorch paths, exactly what the JAX package runs off
the TPU (``attention_any``, ``ssd_chunked``).  Same function, so the
models' results do not depend on the dispatch beyond rounding.

K2 and K3 have no backward: a CUDA input that requires grad while grad
mode is on raises rather than being detached silently.  The training
forward calls the plain paths directly, as the JAX package does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _k2
from repro_torch.kernels import ssd_scan as _k3


def _cpu_only(t) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain path for device {t.device}")


def _no_backward(kernel: str, *inputs) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{kernel} has no backward: an input requires grad, and the "
            f"kernel's output would not carry it; differentiate the plain "
            f"path (models.attention.attention_any, models.mamba.ssd_chunked) "
            f"or call under torch.no_grad()")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    chunk_size: int = 512, dense_threshold: int = 2048):
    """Causal GQA attention.  ``chunk_size`` and ``dense_threshold`` steer
    the CPU path only."""
    if q.device.type == "cuda":
        _no_backward("K2 (flash attention)", q, k, v)
        return _k2.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    _cpu_only(q)
    from repro_torch.models.attention import attention_any
    return attention_any(q, k, v, causal=causal, window=window,
                         chunk_size=chunk_size,
                         dense_threshold=dense_threshold, scale=scale)


def ssd_scan(x, dt, A, B, C, *, chunk_size: int = 128):
    """Mamba-2 SSD; returns ``(y, final_state)``.  ``chunk_size`` is the
    CPU path's chunk (it must divide S there); the kernel uses its own."""
    if x.device.type == "cuda":
        _no_backward("K3 (SSD scan)", x, dt, A, B, C)
        return _k3.ssd_scan(x, dt, A, B, C)
    _cpu_only(x)
    from repro_torch.models.mamba import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, chunk_size)
