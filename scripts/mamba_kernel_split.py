#!/usr/bin/env python3
"""Split each call of the Mamba block's K6 (causal conv + SiLU) and K7 (D
skip + gated norm) into its CUDA kernels, for any checkout of the port
from the block kernels on.

Shapes (bf16, random inputs from a seed; d_conv 4): mamba2-1.3b's
training (K6 over xs, B, C of 4 x 2048 tokens with 4096 + 128 + 128
channels, forward and backward; K7 over 8192 rows of 4096, 64 heads,
forward and backward), its prefill (2000 tokens, K6 keeping its states)
and decode (one token: K6 from the states, K7 without the skip), and
jamba-1.5-large-398b's layer width (K7 over 2048 rows of 16384, 128
heads, forward and backward).  For each call: device ms of one call
(``chip_smoke.graph_ms``: 20 calls captured in a CUDA graph, the replay
timed with CUDA events) and the same replay traced by ``torch.profiler``,
split by CUDA kernel (``chip_smoke.graph_split``), beside the call's
bytes bound at 3.35 TB/s.

Run on a machine with the card, from the repository root (under a
minute a tree):

    python3 scripts/mamba_kernel_split.py [--tree DIR]

``--tree`` names the checkout whose ``src`` is imported and built
(default: this one), so two checkouts can be timed in turns in one call.
The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its timing and profiling helpers)

K = 4


def calls(torch, K6, K7, dev):
    """(name, fn, kernel name key, bytes) of every call timed."""
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, shift=0.0, dt=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                + shift).to(dt)

    def nbytes(ts):
        return chip_smoke.tensor_bytes(list(ts))

    out = []
    for label, bt, s, kind in (("train", 4, 2048, "train"),
                               ("prefill", 1, 2000, "prefill"),
                               ("decode", 1, 1, "decode")):
        widths = (4096, 128, 128)
        xs = [rnd(bt, s, c) for c in widths]
        ws = [rnd(K, c, scale=0.3) for c in widths]
        bs = [rnd(c, scale=0.1) for c in widths]
        st = [rnd(bt, K - 1, c) for c in widths] if kind == "decode" \
            else None
        keep = kind != "train"

        def k6(xs=xs, ws=ws, bs=bs, st=st, keep=keep):
            return K6.causal_conv(xs, ws, bs, st, keep)
        ys, new = k6()
        out.append((f"K6 forward {label}", k6, "conv_",
                    nbytes(xs + ws + bs + (st or []) + ys + (new or []))))
        if kind == "train":
            gs = [rnd(bt, s, c, scale=1e-2) for c in widths]

            def k6b(xs=xs, ws=ws, bs=bs, gs=gs):
                return K6.causal_conv_backward(xs, ws, bs, gs)
            d = k6b()
            out.append((f"K6 backward {label}", k6b, "conv_",
                        nbytes(xs + ws + bs + gs
                               + [t for ls in d for t in ls])))
    for label, rows, di, h, kind in (("train", 8192, 4096, 64, "train"),
                                     ("prefill", 2000, 4096, 64, "prefill"),
                                     ("decode", 1, 4096, 64, "decode"),
                                     ("jamba train", 2048, 16384, 128,
                                      "train")):
        y, x, z = (rnd(rows, di) for _ in range(3))
        D = rnd(h, scale=0.1, shift=1.0, dt=torch.float32)
        sc = rnd(di, scale=0.1, shift=1.0, dt=torch.float32)
        if kind == "decode":
            x, D = None, None

        def k7(y=y, x=x, z=z, D=D, sc=sc):
            return K7.gated_norm(y, x, z, D, sc)
        o, r = k7()
        out.append((f"K7 forward {label}", k7, "gn_",
                    nbytes([y, x, z, D, sc, o])))
        if kind == "train":
            dout = rnd(rows, di, scale=1e-2)

            def k7b(y=y, x=x, z=z, D=D, sc=sc, r=r, dout=dout):
                return K7.gated_norm_backward(dout, y, x, z, D, sc, r)
            g = k7b()
            out.append((f"K7 backward {label}", k7b, "gn_",
                        nbytes([dout, y, x, z, D, sc, r, *g])))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mamba_kernel_split: no CUDA device", file=sys.stderr)
        return 2
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import gated_norm as K7
    from repro_torch.kernels import mamba_conv as K6
    for b in [K6.start_build(), K7.start_build()]:
        b.wait()
    dev = torch.device("cuda")
    card = chip_smoke.smi_line()
    print(f"card: {card}; tree {tree}", flush=True)
    rows = {}
    for name, fn, key, nb in calls(torch, K6, K7, dev):
        ms = chip_smoke.graph_ms(torch, fn)
        split = chip_smoke.graph_split(torch, fn, key)
        bound = nb / chip_smoke.HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": ms, "bytes": nb, "bytes_bound_ms": bound,
                      "share_of_bound": bound / ms,
                      "split": None if split is None else {
                          k: {"launches": c, "ms": m}
                          for k, (c, m) in split.items()}}
        print(f"{name}: ms={ms:.4f} bytes_bound_ms={bound:.4f} "
              f"share_of_bound={bound / ms:.3f} split (device ms of one "
              f"call by CUDA kernel, launches): "
              f"{chip_smoke.split_text(split)}", flush=True)
    print(json.dumps({"tree": str(tree), "card": card,
                      "device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "calls": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
