#!/usr/bin/env python3
"""What holds K8 (the Mamba decode layer's state step) back: its time with
one part of its work taken out at a time.

Each variant is ``csrc/mamba_decode.cu`` with a few lines replaced (found
by their text; the script stops if one moved), built with ``nvcc`` into
``build/k8_variants/`` and launched through ``kernels/mamba_decode.py``'s
own wrapper.  The variants compute wrong results on purpose and are only
timed:

- ``as_is``: the kernel unchanged;
- ``relaxed``: the group counter's atomic relaxed, not acq_rel;
- ``no_counter``: no atomic and no write of the group's B/C state;
- ``no_silu``: the convs' arithmetic skipped (their windows still loaded);
- ``no_state``: the float32 state neither read nor written (zeros);
- ``bare``: ``no_counter``, ``no_silu`` and ``no_state`` together.

Device ms of one call (``chip_smoke.graph_ms``: 20 calls captured in a
CUDA graph, the replay timed with CUDA events) at mamba2-1.3b's decode
(batch 1, 64 heads of 64, N 128, bf16), jamba's layer (128 heads of 128)
and the reduced config (8 heads of 16, N 16).

Run on a machine with the card, from the repository root (about a
minute):

    python3 scripts/k8_variants.py

The last line is one JSON object with every number.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402  (its timing helpers)

SRC = ROOT / "src" / "repro_torch" / "csrc" / "mamba_decode.cu"
OUT = ROOT / "build" / "k8_variants"

RELAXED = ("atom.acq_rel.gpu.add.u32", "atom.relaxed.gpu.add.u32")
COUNTER = ("ticket = count(a.counters + b * G + g);", "ticket = -1;")
SILU = ("  return rnd<T>(silu(rnd<T>(__fadd_rn(acc, c.bias))));",
        "  return c.win[DEC_K - 1];")
LOAD = ("        ? *reinterpret_cast<const float4*>(srow + (size_t)n * P)",
        "        ? make_float4(0.f, 0.f, 0.f, (float)n)")
STORE = ("      *reinterpret_cast<float4*>(srow + (size_t)n * P) =\n"
         "          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);",
         "      if (s[i][0] == 12345.f) srow[0] = s[i][1];")
VARIANTS = {"as_is": (), "relaxed": (RELAXED,), "no_counter": (COUNTER,),
            "no_silu": (SILU,), "no_state": (LOAD, STORE),
            "bare": (COUNTER, SILU, LOAD, STORE)}
# name, heads, head dim, N
SHAPES = (("mamba2-1.3b decode", 64, 64, 128),
          ("jamba layer decode", 128, 128, 128),
          ("reduced decode", 8, 16, 16))


def build(name: str, edits) -> subprocess.Popen:
    text = SRC.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"k8_variants: {name}: the line {old!r} moved")
        text = text.replace(old, new)
    src = OUT / f"{name}.cu"
    src.write_text(text)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
         str(OUT / f"lib{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def main() -> int:
    import ctypes

    import torch
    if not torch.cuda.is_available():
        print("k8_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import mamba_decode as K8
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k8_variants: {name}: nvcc failed\n{err}")
    card = chip_smoke.smi_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, dt=bf):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)
    cases = []
    for label, h, p, n in SHAPES:
        widths = (h * p, n, n)
        cases.append((label, [rnd(1, 1, c) for c in widths] + [rnd(1, 1, h)],
                      [rnd(4, c) for c in widths], [rnd(c) for c in widths],
                      [rnd(1, 3, c) for c in widths],
                      rnd(1, h, n, p, dt=torch.float32),
                      [rnd(h, dt=torch.float32) for _ in range(3)]))
    out = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        i, ptr = ctypes.c_int, ctypes.c_void_p
        lib.decode_layer_launch.argtypes = [i] * 7 + [ptr, ptr, i, ptr]
        lib.decode_layer_launch.restype = ctypes.c_int
        lib.decode_layer_takes.argtypes = [i] * 3
        lib.decode_layer_takes.restype = ctypes.c_int
        K8._lib = lib
        for label, proj, ws, bs, states, ssm, vec in cases:
            def call(proj=proj, ws=ws, bs=bs, states=states, ssm=ssm,
                     vec=vec):
                return K8.decode_layer(*proj, ws, bs, states, ssm, *vec)
            ms = chip_smoke.graph_ms(torch, call)
            out.setdefault(label, {})[name] = ms
            print(f"{label} {name}: ms={ms:.4f}", flush=True)
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
