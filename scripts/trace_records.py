#!/usr/bin/env python3
"""Count the kernel records that ``torch.profiler`` keeps from one replay
of a captured train step, trace after trace, to see whether and where a
trace loses records.

A ``TrainProgram`` for ``--arch`` at full width (``--layers`` cuts the
depth; ``--moments bfloat16`` as phase 18e), bf16, 4 x 2048 tokens of
``SyntheticLM``, takes its warm-up step and captures one step.  Then
``--traces`` traces of one replay each, tracing the card only; every
second trace waits ``--pad-ms`` after it starts before the replay and
after the replay has ended before it stops, as ``chip_smoke.profiled``
does (a record that falls outside the trace's window is dropped).  A graph runs the same
kernels at every replay, so each kernel name's largest count over the
traces is its true count; for every trace the script prints its kernel
count, the names it is short of and, for each missing record, where it
falls in the step (the share of the step's device time before it).  The
last line is one JSON object.  Run on a machine with the card, from the
repository root:

    python3 scripts/trace_records.py [--arch yi-6b] [--layers N]
                                     [--moments bfloat16] [--traces 20]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH, SEQ = 4, 2048


def trace(torch, fn, pad_s: float) -> list[tuple[str, float]]:
    """(name, start µs) of every kernel record of one call, by start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return sorted(((e.name, e.time_range.start) for e in prof.events()
                   if e.device_type == DeviceType.CUDA), key=lambda x: x[1])


def missing_at(full: list, short: list, name: str) -> list[float]:
    """Where ``short``'s records of ``name`` fall short of ``full``'s: for
    each missing one, the share of ``full``'s step that precedes it."""
    t0, t1 = full[0][1], full[-1][1]
    a = [t for n, t in full if n == name]
    b = [t - short[0][1] + t0 for n, t in short if n == name]
    out, j = [], 0
    for i, t in enumerate(a):
        nxt = a[i + 1] if i + 1 < len(a) else float("inf")
        if j < len(b) and b[j] < (t + nxt) / 2:
            j += 1
        else:
            out.append((t - t0) / max(t1 - t0, 1e-9))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--moments", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--traces", type=int, default=20)
    ap.add_argument("--pad-ms", type=float, default=50.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_records: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import init_params
    from repro_torch.train import loop
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    tcfg = loop.TrainConfig(optimizer=AdamWConfig(
        moment_dtype=getattr(torch, args.moments)))
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH)
    batch = loop.batch_to_device(src.batch_from_shard(src.load_shard(0)),
                                 dev)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    program = loop.TrainProgram(loop.make_train_step(cfg, tcfg), params,
                                adamw_init(params, tcfg.optimizer), batch)
    program.step(batch)                      # warm-up and capture
    runs = []
    for i in range(args.traces):
        pad = args.pad_ms / 1e3 if i % 2 else 0.0
        runs.append((pad, trace(torch, program.graph.replay, pad)))
    counts = [collections.Counter(n for n, _ in r) for _, r in runs]
    true = collections.Counter()
    for c in counts:
        true |= c
    full = next(r for (_, r), c in zip(runs, counts) if c == true) \
        if true in counts else None
    rows = []
    for (pad, r), c in zip(runs, counts):
        short = {n: true[n] - c[n] for n in true if c[n] < true[n]}
        where = {n[:60]: missing_at(full, r, n) for n in short} \
            if full is not None else None
        rows.append({"pad_ms": pad * 1e3, "kernels": len(r),
                     "missing": sum(short.values()),
                     "short": {n[:60]: k for n, k in short.items()},
                     "where": where})
        print(f"trace {len(rows)}: pad_ms={pad * 1e3:.0f} kernels="
              f"{len(r)} missing={rows[-1]['missing']} where={where}")
    out = {"arch": args.arch, "n_layers": cfg.n_layers,
           "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda, "true_kernels": sum(true.values()),
           "traces": rows}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
