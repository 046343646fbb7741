#!/usr/bin/env python3
"""Serve full-width models through several checkouts of the port in turns
on one card: each tree's own phase 10 (yi-6b) or phase 11 (mamba2-1.3b)
of ``chip_smoke.py``, so two versions compare within one call.

Each (tree, arch) runs in a child process of its own from that tree's
root: it imports the tree's ``chip_smoke.py`` and ``src/``, builds the
serving kernels (K1, K2, K3, K6, K7, K8) into the tree's
``build/kernels`` with one ``nvcc`` each at once, and runs
``chip_smoke.full_serve``: 15 requests of a 2000-token prompt and 16 new
tokens through ``ServeEngine`` (the decode captured in a CUDA graph), then
one cold request profiled: unprofiled graph and eager decode tokens/s and
one graph replay traced on the card (kernels and device ms a token).
Each child's whole output goes to ``build/serve_ab/``; its key lines
and its summary are printed here.

Run on a machine with the card, from the repository root (about a minute
a run):

    git archive <parent> | tar -x -C build/parent
    python3 scripts/serve_ab.py --tree build/parent --tree . --tree . \\
        --tree build/parent [--arch mamba2-1.3b] [--arch yi-6b]

The last line is one JSON object with every run's summary, in run order.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "serve_ab"
KEYS = ("unprofiled decode", "one decode token", "block kernel wrapper",
        "graph vs eager decode", "requests=", "nvidia", "NVIDIA")

# run from the tree's root: argv = arch
CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, ".")
sys.path.insert(0, "src")
import chip_smoke as C
from repro_torch.kernels import arima_bank as K1
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import gated_norm as K7
from repro_torch.kernels import mamba_conv as K6
from repro_torch.kernels import mamba_decode as K8
from repro_torch.kernels import ssd_scan as K3
arch = sys.argv[1]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
C.log(C.smi_line())
t0 = time.perf_counter()
for b in [m.start_build() for m in (K1, K2, K3, K6, K7, K8)]:
    b.wait()
C.log(f"builds seconds={time.perf_counter() - t0:.1f}")
counts = {"K1": K1, "K2": K2, "K3": K3, "K6": K6, "K7": K7, "K8": K8}
kernel, phase = ("K2", "phase 10") if arch == "yi-6b" else ("K3", "phase 11")
C.full_serve(torch, arch, kernel, counts, torch.device("cuda"), phase)
out = C.SERVED[arch]
print("SUMMARY " + json.dumps({k: out.get(k) for k in (
    "decode_tokens_per_s_graph", "decode_tokens_per_s_eager",
    "token_kernels", "token_device_ms", "token_calls",
    "token_memcpy_dtod", "decode_tokens_per_s_median",
    "ttft_cold_ms_median", "ttft_prewarmed_ms_median", "seconds",
    "graph_tokens_equal")}), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout's root, in run order (repeat it)")
    ap.add_argument("--arch", action="append",
                    choices=("mamba2-1.3b", "yi-6b"),
                    help="models served by each tree (default mamba2-1.3b)")
    args = ap.parse_args()
    OUT.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, tree in enumerate(args.tree):
        root = pathlib.Path(tree).resolve()
        for arch in args.arch or ["mamba2-1.3b"]:
            proc = subprocess.run([sys.executable, "-c", CHILD, arch],
                                  cwd=root, capture_output=True, text=True)
            log = OUT / f"{i}_{arch}.log"
            log.write_text(proc.stdout + proc.stderr)
            summary = None
            print(f"== run {i}: {root} {arch} exit={proc.returncode} "
                  f"(log {log.relative_to(ROOT)})", flush=True)
            for line in proc.stdout.splitlines():
                if line.startswith("SUMMARY "):
                    summary = json.loads(line[len("SUMMARY "):])
                elif any(k in line for k in KEYS):
                    print("  " + line[:400], flush=True)
            if proc.returncode:
                print(proc.stderr[-3000:], flush=True)
                return proc.returncode
            runs.append({"run": i, "tree": str(root), "arch": arch,
                         **summary})
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
