"""Gradient compression with error feedback.

Cross-pod gradient reduction is the dominant collective at multi-pod
scale: the links between pods are far slower than those within one.  The
cross-pod reduction is compressed to int8 with per-block scales, and the
quantization residual stays local (error feedback), which preserves SGD's
convergence.

``compressed_all_reduce`` quantizes locally and all-reduces the
dequantized blocks in one bfloat16 payload over a process group (the
``pod`` axis's); the reduction within a pod stays full precision.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization.  Returns (q, scales)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: tuple, dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def compress_with_feedback(grad: torch.Tensor, residual: torch.Tensor):
    """Error-feedback compression: compress (grad + residual), return the
    dequantized value and the new residual."""
    g = grad.float() + residual
    q, scale = quantize_int8(g)
    deq = dequantize_int8(q, scale, g.shape, torch.float32)
    return deq.to(grad.dtype), g - deq


def compressed_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over ``group`` with an int8-quantized payload: each
    rank quantizes locally, and the dequantized blocks (q · scale) cross
    the wire in one bfloat16 all-reduce."""
    q, scale = quantize_int8(x)
    contrib = q.to(torch.bfloat16) * scale.to(torch.bfloat16)
    dist.all_reduce(contrib, group=group)
    n = x.numel()
    return contrib.float().reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def make_crosspod_grad_sync(mesh, compress: bool = True):
    """Return a function tree->tree that averages gradients across the
    ``pod`` axis, int8-compressed when ``compress``: each rank's tensor
    (a DTensor's local shard) is reduced with its peers in the other pods.

    For the async/hierarchical sync mode, where each pod's data-parallel
    group computes its own gradients; a plain sharded step reduces them
    implicitly and leaves this off.
    """
    if "pod" not in mesh.mesh_dim_names:
        return lambda tree: tree
    group = mesh.get_group("pod")
    pods = mesh.shape[mesh.mesh_dim_names.index("pod")]

    def sync_local(g):
        if compress:
            return compressed_all_reduce(g, group) / pods
        g = g.clone()
        dist.all_reduce(g, group=group)
        return g / pods

    def sync_leaf(g):
        if isinstance(g, DTensor):
            return DTensor.from_local(sync_local(g.to_local()),
                                      g.device_mesh, g.placements,
                                      run_check=False)
        return sync_local(g)

    return lambda tree: pytree.tree_map(sync_leaf, tree)
