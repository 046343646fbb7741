#!/usr/bin/env python3
"""Split one train step's device time into the forward and backward, the
optimizer update and the rest, for any checkout of the port from the
train graph on (``TrainProgram``).

For ``--arch`` at full width (``--layers`` cuts the depth), bf16, the
default ``TrainConfig``, 4 x 2048 tokens of ``SyntheticLM``:

1. a ``TrainProgram`` over fresh parameters takes its warm-up step and
   captures one step; the peak memory of that (``max_memory_allocated``
   after ``reset_peak_memory_stats``) beside the bytes of the parameters
   and optimizer state; then a replay's wall ms (CUDA events, the mean
   of ``--reps`` after one more) and its device busy ms by
   ``torch.profiler``, its kernels summed by ``chip_smoke.op_class`` (K3
   forward and backward, GEMMs, the AdamW kernel K5, the rest);
2. the forward and backward alone: ``train.loop._value_and_grad`` on the
   program's parameters and batch, device busy ms;
3. the update alone: the program's eager step with ``_value_and_grad``
   replaced by one that hands back the gradients of step 2, so that only
   what follows the gradients runs (the norm, the per-tensor update, and
   in checkouts before the in-place update the ``torch.where`` NaN-skip
   and the ``copy_`` back into the program's tensors), device busy ms.

The rest is the replay's busy ms less the two parts.  The last line is
one JSON object with every number.  Run on a machine with the card, from
the repository root:

    python3 scripts/train_step_split.py [--tree DIR] [--arch mamba2-1.3b]
                                        [--layers N] [--reps 3]

``--tree`` names the checkout whose ``src`` is imported (default: this
one), so two checkouts can be timed in turns in one call.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its tracing, timing and kernel classes)

BATCH, SEQ = 4, 2048


def by_class(table) -> dict:
    out: dict[str, float] = {}
    for e in table:
        k = chip_smoke.op_class(e.key)
        out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3
    return out


def busy_ms(torch, fn) -> tuple[float, list]:
    """Device busy ms of one call of ``fn`` traced on the card, and the
    kernel table."""
    return chip_smoke.profiled(torch, fn, host=False)[1::2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_step_split: no CUDA device", file=sys.stderr)
        return 2
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import init_params
    from repro_torch.train import loop
    from repro_torch.train.optimizer import adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    tcfg = loop.TrainConfig()
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH)
    batch = loop.batch_to_device(src.batch_from_shard(src.load_shard(0)),
                                 dev)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    opt = adamw_init(params, tcfg.optimizer)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in pytree.tree_leaves((params, opt)))
    program = loop.TrainProgram(loop.make_train_step(cfg, tcfg), params,
                                opt, batch)
    program.step(batch)                      # warm-up and capture
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    replay_ms = chip_smoke.cuda_ms(program.graph.replay, args.reps)
    replay_busy, table = busy_ms(torch, program.graph.replay)
    classes = by_class(table)

    leaves, spec = pytree.tree_flatten(program.params)
    vag = loop._value_and_grad
    fwd_bwd, _ = busy_ms(torch, lambda: vag(leaves, spec, cfg, batch))
    fixed = vag(leaves, spec, cfg, batch)
    loop._value_and_grad = lambda *a, **k: fixed
    try:
        program._step()                      # once untimed
        update, utable = busy_ms(torch, program._step)
    finally:
        loop._value_and_grad = vag
    out = {
        "tree": str(tree), "arch": args.arch, "n_layers": cfg.n_layers,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "state_bytes": state_bytes, "peak_gib": peak / 2**30,
        "peak_reserved_gib": reserved / 2**30,
        "replay_ms": replay_ms, "replay_busy_ms": replay_busy,
        "replay_kernels": sum(e.count for e in table),
        "replay_by_class": classes,
        "fwd_bwd_busy_ms": fwd_bwd, "update_busy_ms": update,
        "update_kernels": sum(e.count for e in utable),
        "rest_busy_ms": replay_busy - fwd_bwd - update,
        "update_largest": [(e.key[:80], e.self_device_time_total / 1e3,
                            e.count) for e in sorted(
            utable, key=lambda e: -e.self_device_time_total)[:6]],
    }
    print(f"{args.arch} ({cfg.n_layers} layers) from {tree}: replay "
          f"{replay_ms:.2f} ms (busy {replay_busy:.2f}); forward+backward "
          f"{fwd_bwd:.2f}; update {update:.2f} ({out['update_kernels']} "
          f"kernels); rest {out['rest_busy_ms']:.2f}; peak "
          f"{peak / 2**30:.2f} GiB (reserved {reserved / 2**30:.2f}) beside "
          f"{state_bytes / 2**30:.2f} GiB of parameters and state")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
