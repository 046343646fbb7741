#!/usr/bin/env python3
"""How far K3's backward on bfloat16 inputs lies from its plain version,
and how far it would lie if its float32 operands lost their lo terms.

The chunked route's tensor-core passes (the reverse walk of the state's
cotangent and the gradient pass) carry every float32 factor (chunk
states and cotangents, the masked score products, the chunk weights) as
two bfloat16 terms, hi = bf16(v) and lo = bf16(v - hi)
(``csrc/ssd_scan_bwd.cu``, ``split``).  This script builds the backward
twice from the checkout's source: as it is, and as a control whose
``split`` sets every lo term to zero, so that each factor enters rounded
to bfloat16.  It holds both against ``ssd_scan_backward_plain`` (eager
float32) on the bfloat16 shapes of the card tests and of
``chip_smoke.py`` phase 9b, inputs made as the card tests make them, and
prints the relative L2 of each gradient, then one JSON line with the
largest of each build.  Both builds take the incoming chunk states of
K3's forward (built as it is), as training does.  A tolerance for the bfloat16 backward belongs
between the two.  Run from the repository root on a machine with the
card:

    python3 scripts/k3_bwd_lo_control.py
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402

# bt, s, h, p, g, n: the bfloat16 shapes of tests/test_torch_cuda.py's
# backward test and of chip_smoke.py phase 9b
SHAPES = [(1, 256, 2, 128, 1, 128), (2, 300, 4, 64, 2, 128),
          (2, 256, 4, 128, 2, 64), (1, 200, 4, 64, 1, 64),
          (2, 40, 12, 64, 1, 64), (1, 200, 20, 64, 2, 128),
          (2, 300, 8, 16, 2, 16), (1, 100, 2, 16, 1, 64),
          (1, 2048, 8, 16, 1, 16), (1, 2048, 8, 64, 1, 16),
          (4, 2048, 64, 64, 1, 128)]
GRADS = ("dx", "ddt", "dA", "dB", "dC")
LO = "lo = pack_bf16(v0 - h.x, v1 - h.y);"


def inputs(dev, bt, s, h, p, g, n, seed):
    """As tests/test_torch_cuda.py's ``_bwd_inputs``, in bfloat16: the
    backward's arguments, the forward's kept states last."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = randn(bt, s, h, p).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(randn(bt, s, h))
    A = -torch.exp(randn(h) * 0.5)
    B = randn(bt, s, g, n).to(torch.bfloat16)
    C = randn(bt, s, g, n).to(torch.bfloat16)
    dy = randn(bt, s, h, p).to(torch.bfloat16)
    dfinal = randn(bt, h, n, p)
    _, _, states = K3.ssd_scan(x, dt, A, B, C, keep_states=True)
    return x, dt, A, B, C, dy, dfinal, states


def control_source() -> pathlib.Path:
    """A directory beside the package's build holding the backward's
    source with every lo term zero; the package's loader builds it there
    with its own flags."""
    src = (nvcc.CSRC / "ssd_scan_bwd.cu").read_text()
    if src.count(LO) != 1:
        raise RuntimeError("ssd_scan_bwd.cu: the lo term of split() not "
                           "found once")
    out = nvcc.BUILD_DIR / "lo_control"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssd_scan_bwd.cu").write_text(
        src.replace(LO, "lo = pack_bf16(0.f, 0.f);"))
    return out


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card)
    cases = [(shape, inputs(dev, *shape, shape[1] + shape[2] + shape[5]))
             for shape in SHAPES]
    wants = [K3.ssd_scan_backward_plain(*args[:7]) for _, args in cases]
    worst = {}
    for build in ("as built", "lo terms zero"):
        if build == "lo terms zero":
            # the loader builds and loads the control's source instead
            nvcc.CSRC = nvcc.BUILD_DIR = control_source()
            K3._bwd_lib = None
        worst[build] = dict.fromkeys(GRADS, 0.0)
        for (shape, args), want in zip(cases, wants):
            got = K3.ssd_scan_backward(*args)
            errs = {k: rel_l2(a, w) for k, a, w in zip(GRADS, got, want)}
            for k, e in errs.items():
                worst[build][k] = max(worst[build][k], e)
            print(f"{build}: {shape} route="
                  f"{K3.backward_route(shape[5], shape[3], torch.bfloat16)}"
                  " rel_l2 " + " ".join(f"{k}={e:.3g}"
                                        for k, e in errs.items()))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "card": card, "torch": torch.__version__,
                      "max_rel_l2": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
