"""Roofline analysis: model FLOPs, active parameters, the three roofline
terms of a dry-run entry, collective bytes and the measured roofline
fraction.

Three terms per (arch × shape × mesh), in seconds:

    compute    = FLOPs / peak_FLOP/s
    memory     = HBM bytes / HBM_bw
    collective = collective bytes / link_bw

all per device.  Hardware constants are the NVIDIA H100 SXM5 datasheet's
figures, not measurements: 989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s HBM3, and 450 GB/s of NVLink 4 per GPU in each direction (the
datasheet's 900 GB/s is both directions of its 18 links together).

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis()`` and
collective bytes from the optimized HLO.  Neither exists here:
:func:`collective_bytes` counts the collectives a run issues (a dispatch
mode over the c10d and functional collectives, result bytes summed under
the same five kind names), and :func:`measured_roofline_fraction` turns a
step's measured device time (``torch.profiler``) into the fraction of its
ideal time.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.transformer import param_shapes

PEAK_FLOPS = 989e12        # bf16 dense / GPU (H100 SXM5 datasheet)
HBM_BW = 3.35e12           # bytes / s / GPU, HBM3 (datasheet)
LINK_BW = 450e9            # bytes / s / GPU, NVLink 4, one direction

_COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute")


def _collective_kinds() -> dict:
    """Collective overloads (functional and c10d) -> kind name.  Built
    when a counter starts: the ops register with ``torch.distributed``."""
    kinds = {}
    names = {
        "_c10d_functional": {
            "all_gather_into_tensor": "all-gather",
            "all_gather_into_tensor_coalesced": "all-gather",
            "all_reduce": "all-reduce",
            "all_reduce_coalesced": "all-reduce",
            "reduce_scatter_tensor": "reduce-scatter",
            "reduce_scatter_tensor_coalesced": "reduce-scatter",
            "all_to_all_single": "all-to-all",
        },
        "c10d": {
            "allgather_": "all-gather",
            "_allgather_base_": "all-gather",
            "allreduce_": "all-reduce",
            "reduce_scatter_": "reduce-scatter",
            "_reduce_scatter_base_": "reduce-scatter",
            "alltoall_": "all-to-all",
            "alltoall_base_": "all-to-all",
            "send": "collective-permute",
        },
    }
    for ns, ops in names.items():
        space = getattr(torch.ops, ns)
        for name, kind in ops.items():
            if hasattr(space, name):
                packet = getattr(space, name)
                for overload in packet.overloads():
                    kinds[getattr(packet, overload)] = kind
    return kinds


def _result_bytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor))


class collective_bytes(TorchDispatchMode):
    """Sum the result bytes of every collective issued inside the block,
    by kind (a per-rank program, so per-device bytes):

        with collective_bytes() as coll:
            step(...)
        coll.bytes  # {"all-gather": ..., "all-reduce": ..., ...}

    c10d's in-place collectives count their output tensors; a ``send``
    counts as a collective permute.
    """

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, int] = {k: 0 for k in _COLLECTIVE_OPS}
        self.calls: dict[str, int] = {k: 0 for k in _COLLECTIVE_OPS}
        self._kinds = _collective_kinds()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = self._kinds.get(func)
        if kind is not None:
            counted = out
            if func._schema.name.startswith("c10d::"):
                counted = args[0]        # in place: the output tensors
            self.bytes[kind] += _result_bytes(counted)
            self.calls[kind] += 1
        return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE), D = tokens
    processed.  For decode shapes D = global_batch (one token each)."""
    n_active = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch
    return 2.0 * n_active * tokens


def active_params(cfg) -> float:
    """Per-token active parameter count (MoE: top-k of routed experts)."""
    total = 0
    moe_total = 0
    n_experts = cfg.moe.n_experts if cfg.moe is not None else -1
    flat, _ = pytree.tree_flatten_with_path(param_shapes(cfg))
    for path, leaf in flat:
        n = leaf.numel()
        names = [str(getattr(k, "key", "")) for k in path]
        # routed-expert leaves carry an n_experts axis
        is_expert = (any(n_ == "mlp" for n_ in names)
                     and n_experts > 0 and leaf.dim() >= 3
                     and n_experts in leaf.shape[:-2])
        if is_expert:
            moe_total += n
        else:
            total += n
    if cfg.moe is not None and moe_total:
        active_frac = cfg.moe.top_k / cfg.moe.n_experts
        total += moe_total * active_frac
    return float(total)


def roofline_terms(entry: dict[str, Any], cfg=None,
                   shape=None) -> dict[str, Any]:
    """Derive the three roofline terms for one dry-run entry (per-device
    quantities / per-GPU rates).  ``shape`` (a ``ShapeSpec``) defaults to
    the grid's entry named ``entry["shape"]``."""
    flops = entry.get("flops", 0.0)
    # memory term: the analytical HBM model
    bytes_acc = entry.get("hbm_model_bytes",
                          entry.get("bytes_accessed", 0.0))
    coll = entry.get("collective_bytes", {})
    coll_total = float(sum(coll.values()))
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_acc / HBM_BW
    t_coll = coll_total / LINK_BW
    dominant = max(
        [("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)], key=lambda kv: kv[1])[0]
    out = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
    }
    if cfg is not None:
        from repro_torch.configs.base import SHAPES
        shape = shape or SHAPES[entry["shape"]]
        mf = model_flops(cfg, shape)
        n_dev = entry.get("n_devices", 1)
        out["model_flops_global"] = mf
        # per-device counted flops vs per-device share of useful flops
        useful_per_dev = mf / max(n_dev, 1)
        out["useful_flops_ratio"] = (useful_per_dev / flops) if flops else 0.0
        bound = max(t_compute, t_memory, t_coll)
        ideal_compute = useful_per_dev / PEAK_FLOPS      # MFU-style limit
        # MBU-style limit: minimum unavoidable HBM traffic (weights + KV
        # read once per step) — THE roofline for decode
        min_bytes = entry.get("min_hbm_bytes",
                              entry.get("param_bytes_per_dev", 0.0))
        ideal_memory = min_bytes / HBM_BW
        out["ideal_compute_s"] = ideal_compute
        out["ideal_memory_s"] = ideal_memory
        out["roofline_fraction"] = (max(ideal_compute, ideal_memory) / bound
                                    if bound > 0 else 0.0)
    return out


def measured_roofline_fraction(terms: dict[str, Any],
                               device_s: float) -> float:
    """The ideal time of ``terms`` (:func:`roofline_terms` with a config:
    the larger of its ideal compute and ideal memory times) over a
    measured step's device seconds (``torch.profiler``'s device time, or
    CUDA events)."""
    ideal = max(terms["ideal_compute_s"], terms["ideal_memory_s"])
    return ideal / device_s if device_s > 0 else 0.0
