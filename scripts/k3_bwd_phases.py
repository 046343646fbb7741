#!/usr/bin/env python3
"""Where one block of K3's backward gradient pass spends its cycles.

Builds ``csrc/ssd_scan_bwd.cu`` a second time with ``clock64()`` probes
around the phases of the bf16 gradient pass's per-head loop
(``tcb::bwd_grad_mma``): thread 0 of every block adds each phase's
cycles, as it sees them, to a device counter.  It runs one backward call
at mamba2-1.3b's training shape (4 x 2048 tokens, 64 heads of 64, N = 128,
bf16) and prints each phase's cycles per block and share, then the call's
time with the probes in (CUDA events).  A phase that ends in a barrier
includes the wait for the block's slowest warp.  The probes find their
places by the comments of the source; the script stops if one is not
found once.  Run from the repository root on a machine with the card:

    python3 scripts/k3_bwd_phases.py
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402

# (text of the source a probe goes before, the phase that ends there)
PHASES = [
    ("    __syncthreads();  // the previous head's tiles and vectors read\n",
     None),
    ("    const float total = cum[L - 1];\n    if (mid_cotangent) {",
     "this head's rows by cp.async, cumsums"),
    ("    // M = dy x^T; SW, MW dt_j (hi + lo) and T = SW M dt_j\n",
     "dS into the tiles (first halves: its product)"),
    ("    {  // row sums minus column sums of T", "M, SW, MW, T"),
    ("    const float e0 = expf(total - cum[i0])", "dcum from T"),
    ("    // dB += dt_j e_j (dS x_j) + (MW^T C)_j\n", "dx products"),
    ("    __syncthreads();  // dS fully read\n", "dB products"),
    ("    // S_prev into the state tiles, and <S_prev, dS>: the forward's "
     "state\n", "barrier"),
    ("    // dC += exp(cum_i) (S_prev dy_i) + (MW B)_i\n",
     "S_prev into the tiles (second halves: its product)"),
    ("    // exp(cum_i) dy_i . (C S_prev)_i\n", "dC products"),
    ("    // dcum, its reverse cumsum d(dA), ddt and this chunk's part of "
     "dA, by\n", "C S_prev"),
    ("    if (tid < L && c0 + tid < S)\n      ddt[", "reverse cumsum, dA"),
    ("  // the slab's parts of dB and dC\n", "ddt (the last head)"),
]


def probed_source() -> str:
    src = (nvcc.CSRC / "ssd_scan_bwd.cu").read_text()
    a = src.index("bwd_grad_mma(const bf16* __restrict__ x")
    b = src.index("}  // namespace tcb")
    body = src[a:b]
    for k, (text, _) in enumerate(PHASES):
        if body.count(text) != 1:
            raise RuntimeError(f"probe place not found once: {text!r}")
        add = "" if k == 0 else \
            f"atomicAdd(&g_phase[{k}], now - g_last); "
        body = body.replace(text, "    if (tid == 0) { unsigned long long "
                            f"now = clock64(); {add}g_last = now; }}\n"
                            + text)
    body = body.replace("  for (int h = h_begin; h < h_end; ++h) {\n",
                        "  unsigned long long g_last = 0;\n"
                        "  for (int h = h_begin; h < h_end; ++h) {\n", 1)
    body = body.replace("  // the slab's parts of dB and dC\n",
                        "  if (tid == 0) atomicAdd(&g_phase[0], 1ull);\n"
                        "  // the slab's parts of dB and dC\n", 1)
    out = src[:a] + body + src[b:]
    out = out.replace("namespace tcb {\n", "namespace tcb {\n__device__ "
                      "unsigned long long g_phase[16];\n", 1)
    return out + '''
extern "C" int phases_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, tcb::g_phase, 16 * 8);
}
extern "C" int phases_zero() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(tcb::g_phase, z, sizeof(z));
}
'''


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    K3._load()  # the forward, built from the checkout as it is
    out = nvcc.BUILD_DIR / "phase_probes"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssd_scan_bwd.cu").write_text(probed_source())
    nvcc.CSRC = nvcc.BUILD_DIR = out
    lib = K3._load_bwd()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    bt, s, h, p, g, n = 4, 2048, 64, 64, 1, 128

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
    args = (x, dt, A, B, C, dy, dfinal, states)
    K3.ssd_scan_backward(*args)
    torch.cuda.synchronize()
    lib.phases_zero()
    K3.ssd_scan_backward(*args)
    torch.cuda.synchronize()
    raw = (ctypes.c_ulonglong * 16)()
    if lib.phases_read(raw):
        raise RuntimeError("reading the probes failed")
    blocks, cycles = raw[0], list(raw)[1:len(PHASES)]
    total = sum(cycles)
    for (_, name), c in zip(PHASES[1:], cycles):
        print(f"{name:52s} cycles/block={c / blocks:9.0f} "
              f"share={c / total:.3f}")
    heads = min(lib.ssd_scan_bwd_slab_heads(), h // g)  # a block's heads
    print(f"blocks={blocks} cycles_per_head={total / blocks / heads:.0f}")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        K3.ssd_scan_backward(*args)
    end.record()
    torch.cuda.synchronize()
    print(f"backward ms with the probes in: {start.elapsed_time(end) / 5:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
