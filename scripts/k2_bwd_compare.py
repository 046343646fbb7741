#!/usr/bin/env python3
"""Time K2's backward of one or more source trees on one card.

Each ``--tree DIR`` (a checkout, or an unpacked ``git archive`` of one) is
measured in a child process of its own that imports ``repro_torch`` from
``DIR/src`` and builds K2's forward and backward from ``DIR``'s sources;
trees run in the order given, so ``--tree old --tree new --tree new
--tree old`` interleaves two versions on one card.  The measurements are
``chip_smoke.py``'s own and call only what every tree of the port has.
Per tree:

- the backward build's registers and spills (``-Xptxas -v``);
- per shape of ``chip_smoke.ATTN_BWD_SHAPES`` (yi-6b's training shape
  first): the route ``backward_route`` names, the backward's time (CUDA
  events, ``chip_smoke.cuda_ms``), ``scaled_dot_product_attention``'s
  backward on the same inputs in the same process
  (``chip_smoke.sdpa_backward_ms``), the gradients' relative L2 against
  the plain backward, and two calls bitwise equal.

The last line is one JSON object with every tree's numbers.  Run from the
repository root on a machine with the card:

    python3 scripts/k2_bwd_compare.py --tree build/parent --tree . \\
        --tree . --tree build/parent
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MARK = "k2_bwd_compare "


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as S
    from repro_torch.kernels import flash_attention as K2

    if not torch.cuda.is_available():
        raise SystemExit("k2_bwd_compare: no CUDA device")
    t0 = time.perf_counter()
    fwd = K2.start_build()
    spills = S.log_build("K2 backward", K2.start_build_backward(
        verbose=True).wait(), time.perf_counter() - t0)
    fwd.wait()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(32)
    rec: dict = {"tree": str(tree), "device": torch.cuda.get_device_name(0),
                 "spill_store_bytes": spills, "shapes": []}
    for shape in S.ATTN_BWD_SHAPES:
        b, s, hq, hkv, d, window, dname = shape
        dtype = getattr(torch, dname)
        q, k, v, do = S.attention_inputs(torch, gen, dev, b, s, hq, hkv, d,
                                         dtype)
        o, lse = K2.flash_attention(q, k, v, window=window, return_lse=True)
        args = (q, k, v, o, lse, do)
        got = K2.flash_attention_backward(*args, window=window)
        again = K2.flash_attention_backward(*args, window=window)
        bitwise = all(bool(torch.equal(x, y)) for x, y in zip(got, again))
        del again
        want = K2.flash_attention_backward_plain(*args, window=window)
        rel = [float((x.float() - w.float()).norm() / w.float().norm())
               for x, w in zip(got, want)]
        del got, want
        S.free(torch)
        ms = S.cuda_ms(lambda: K2.flash_attention_backward(*args,
                                                           window=window),
                       reps=10)
        sdpa = S.sdpa_backward_ms(torch, q, k, v, do, window)
        row = {"shape": list(shape), "route": K2.backward_route(d, dtype),
               "ms": ms, "sdpa_backward_ms": sdpa, "rel_l2": rel,
               "bitwise_two_calls": bitwise}
        rec["shapes"].append(row)
        S.log(f"{shape} route={row['route']} ms={ms:.4f} "
              f"sdpa_backward_ms={sdpa:.4f} rel_l2="
              + ",".join(f"{x:.3g}" for x in rel)
              + f" bitwise_two_calls={bitwise}")
        del q, k, v, do, o, lse, args
        S.free(torch)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", type=Path, default=[],
                    help="source tree to measure (repeatable, in order)")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        rec = measure(args.one.resolve())
        print(MARK + json.dumps(rec), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S
    smi = S.smi_line()
    print(smi, flush=True)
    results = []
    for tree in args.tree or [ROOT]:
        print(f"== tree {tree}", flush=True)
        proc = subprocess.run([sys.executable, __file__, "--one", str(tree)],
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith(MARK):
                results.append(json.loads(line[len(MARK):]))
            else:
                print(line, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    print(smi, flush=True)
    print(json.dumps({"k2_bwd_compare": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
