#!/usr/bin/env python3
"""ptxas's registers and spills for K2's backward on ``wgmma`` at D = 256,
a head dim that stays on ``mma``.

Builds ``csrc/flash_attention_bwd.cu`` a second time with the ``wgmma``
route instantiated at D = 256 as well (``wg::Shape``'s assert relaxed to
whole 64-column panels, the build mask widened), compile only
(``-cubin``), and prints ptxas's registers and spill bytes for every
``wgmma`` kernel: the evidence for keeping D = 256 on ``mma`` (D = 160
would hold three panels of dK and dV, 192 float32, beside S^T).  Run from
the repository root on a machine with ``nvcc``:

    python3 scripts/k2_bwd_wide_ptxas.py
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu"
ASSERT = ('static_assert(D == 64 || D == 128, "the wgmma route takes D = 64 '
          'or 128");')
WIDE = (64, 128, 256)


def mask(dims) -> str:
    return f"{sum(1 << (d // 32 - 1) for d in dims):#x}u"


def main() -> int:
    src = SRC.read_text()
    if src.count(ASSERT) != 1:
        raise SystemExit("the wgmma route's head-dim assert was not found")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory() as tmp:
        wide = Path(tmp) / "flash_attention_bwd.cu"
        wide.write_text(src.replace(ASSERT, 'static_assert(D % 64 == 0, "");'))
        proc = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-cubin", f"-DFLASH_BWD_MMA_D32_MASK={mask((160,))}",
             f"-DFLASH_BWD_WGMMA_D32_MASK={mask(WIDE)}", "-Xptxas", "-v",
             "-o", str(Path(tmp) / "wide.cubin"), str(wide)],
            capture_output=True, text=True)
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
        return proc.returncode
    name = None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(flash_bwd_\w+?_wgmmaILi\d+)", line)
            name = m.group(1) if m else None
        elif name and ("Used" in line or "spill" in line):
            print(f"{name}: {line.split(':', 1)[-1].strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
