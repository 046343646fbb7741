#!/usr/bin/env python3
"""Where the blocks of K2's backward spend their cycles, phase by phase.

Builds ``csrc/flash_attention_bwd.cu`` a second time with ``clock64()``
probes around the phases of both walks of the route that
``backward_route`` names at yi-6b's training shape (4 x 2048 tokens, 32/4
heads of 128, bf16): the dK/dV walk (one block per kv head, batch and tile
of keys) and the dQ walk (one block per kv head, batch and tile of folded
rows).  Phases of one step of either walk:

- wait: the streamed tiles arrive (and, on ``mma``, the barriers that
  guard them);
- the two products that recompute the scores and their cotangent (S^T
  and dP^T; S and dP);
- exp and dS from them (on ``mma`` also the stores of P and dS into
  shared memory and the barrier after; on ``wgmma`` in registers,
  between the products);
- the products that take P and dS (dV and dK; dQ);
- on ``wgmma``, the copies of a later step (issued while the first
  product runs) and the release of the stage.

One thread of every block (``--thread``: 0, the first warpgroup's first
thread, by default; 128 the second's) adds each phase's cycles, as it
sees them, to a device counter; the blocks' first wait is counted apart
as the prologue.  A phase that ends in a barrier includes the wait for
the block's slowest warp, and an asynchronous product's tail lands in the
phase that first waits for it.  It runs one backward call and prints, per
walk, each phase's cycles per block and per step and its share, then the
call's time with the probes in (CUDA events), and a JSON line with all of
it.  The probes find their places by the comments of the source; the
script stops if one is not found once.  ``--tree DIR`` measures the
sources of another checkout (an unpacked ``git archive``; its route's
probes must be among these).  Run from the repository root on a machine
with the card:

    python3 scripts/k2_bwd_phases.py [--tree DIR] [--thread N]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (4, 2048, 32, 4, 128)  # b, s, hq, hkv, d: yi-6b's training shape
WALKS = ("dkdv", "dq")
SLOTS = 16  # a walk's counters: 0 blocks, 15 steps, 1.. its phases

# route -> walk -> (the kernel's signature, the text after its body, its
# phases, and its probes: (text of the source the probe goes before, the
# phase the cycles since the last probe go to, 1-based, as a C expression
# of the kernel's locals)).  The probe after a step's wait counts the
# step ("wait" is phase 2 on both routes); the probe "end" ends the walk,
# counts the block and credits the last phase.
PROBES = {
    "mma": {
        "dkdv": ("flash_bwd_dkdv_mma(const bf16* __restrict__ q",
                 "// dQ of one tile of 64 folded rows",
                 ("prologue", "wait", "S^T, dP^T", "exp, dS^T into smem",
                  "dV, dK"), [
                     ("    __syncthreads();  // the previous tile's P, dS "
                      "and buffers fully read\n", "it == 0 ? 1 : 5"),
                     ("    const bf16* tq = sQ + buf * Sh::kTileElems;\n",
                      "2"),
                     ("#pragma unroll\n    for (int nt = 0; nt < 4; ++nt)\n"
                      "#pragma unroll\n      for (int half = 0; half < 2; "
                      "++half) {\n        const int kr", "3"),
                     ("    mm2<kTile, NT, true, Sh::kUnroll>(acc_v, acc_k",
                      "4"),
                     ("#pragma unroll\n  for (int half = 0; half < 2; "
                      "++half) {\n    const int key = k0 + sm0", "end 5"),
                 ]),
        "dq": ("flash_bwd_dq_mma(const bf16* __restrict__ q",
               "template <typename K>\nint set_smem",
               ("prologue", "wait", "S, dP", "exp, dS into smem", "dQ"), [
                   ("    __syncthreads();  // the previous tile's dS and "
                    "buffers fully read\n", "it == 0 ? 1 : 5"),
                   ("    const bf16* tk = sK + buf * Sh::kTileElems;\n", "2"),
                   ("#pragma unroll\n    for (int half = 0; half < 2; "
                    "++half) {\n      const int rl", "3"),
                   ("    mm<kTile, NT, true, Sh::kUnroll>(acc, smem_u32(sdS)",
                    "4"),
                   ("#pragma unroll\n  for (int half = 0; half < 2; ++half) "
                    "{\n    const long long off = row(", "end 5"),
               ]),
    },
    "wgmma": {
        "dkdv": ("flash_bwd_dkdv_wgmma(const __grid_constant__ Args a",
                 "// dQ of one tile of 128 folded rows",
                 ("prologue", "wait", "S^T issued, refill", "S^T",
                  "exp, P^T", "dV and dP^T", "dS^T", "dK", "release"), [
                     ("    stage_wait(&full[st], it, !tma || it == 0);",
                      "it == 0 ? 1 : 9"),
                     ("    // S^T = K . Q^T, keys by rows; while it runs",
                      "2"),
                     ("    if (!dead) {\n      wgmma_wait0();\n"
                      "      fence_regs(s);", "3"),
                     ("      // P^T, rounded to bf16, as A fragments", "4"),
                     ("      // dV += P^T . dO (dO read MN-major) and dP^T",
                      "5"),
                     ("      // dS^T = P^T o (dP^T - D_)", "6"),
                     ("      // dK += dS^T . Q, Q read MN-major", "7"),
                     ("    stage_read(&empty[st], lane);", "8"),
                     ("#pragma unroll\n  for (int half = 0; half < 2; "
                      "++half) {\n    const int key = keyA", "end 9"),
                 ]),
        "dq": ("flash_bwd_dq_wgmma(const __grid_constant__ Args a",
               "}  // namespace wg",
               ("prologue", "wait", "S, dP issued, refill", "S", "exp, P",
                "dP's rest, dS", "dQ", "release"), [
                   ("    stage_wait(&full[st], it, false);", "it == 0 ? 1 : 8"),
                   ("    // S = Q . K^T and dP = dO . V^T, rows by keys, two "
                    "groups; while", "2"),
                   ("    if (!dead) {\n      fence_regs(dp);\n"
                    "      wgmma_wait1();", "3"),
                   ("      // P, rounded to bf16 as the dK/dV walk", "4"),
                   ("      wgmma_wait0();\n      fence_regs(dp);\n\n"
                    "      // dS = P o (dP - D_)", "5"),
                   ("      // dQ += dS . K, K read MN-major", "6"),
                   ("    stage_read(&empty[st], lane);", "7"),
                   ("#pragma unroll\n  for (int half = 0; half < 2; "
                    "++half) {\n    const long long off = row(", "end 8"),
               ]),
    },
}


def probe(base: int, slot: str, thread: int) -> str:
    head = (f"if (threadIdx.x == {thread}) {{ unsigned long long now = "
            "clock64(); ")
    if slot.startswith("end "):
        return (head + f"atomicAdd(&g_phase[{base} + {slot[4:]}], now - "
                f"g_last); atomicAdd(&g_phase[{base}], 1ull); "
                f"atomicAdd(&g_phase[{base} + {SLOTS - 1}], "
                f"(unsigned long long)g_steps); }}\n")
    step = "++g_steps; " if slot == "2" else ""
    return (head + f"atomicAdd(&g_phase[{base} + ({slot})], now - g_last); "
            f"g_last = now; {step}}}\n")


def probed_source(src: str, route: str, thread: int = 0) -> str:
    for walk, (sig, end, _, probes) in PROBES[route].items():
        base = SLOTS * WALKS.index(walk)
        a = src.index(sig)
        b = src.index(end, a)
        body = src[a:b]
        for text, slot in probes:
            if body.count(text) != 1:
                raise RuntimeError(f"probe place not found once: {text!r}")
            body = body.replace(text, probe(base, slot, thread) + text)
        brace = body.index("{\n") + 2
        body = (body[:brace] + "  unsigned long long g_last = clock64();\n"
                "  int g_steps = 0;\n" + body[brace:])
        src = src[:a] + body + src[b:]
    n = SLOTS * len(WALKS)
    anchor = "namespace {\n"
    src = src.replace(anchor, anchor + "__device__ unsigned long long "
                      f"g_phase[{n}];\n", 1)
    return src + f'''
extern "C" int phases_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_phase, {n} * 8);
}}
extern "C" int phases_zero() {{
  unsigned long long z[{n}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}}
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=pathlib.Path, default=ROOT,
                    help="source tree whose backward is probed")
    ap.add_argument("--thread", type=int, default=0,
                    help="the thread of every block that probes (0: the "
                         "first warpgroup's, 128 the second's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.kernels import nvcc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    b, s, hq, hkv, d = SHAPE
    route = K2.backward_route(d, torch.bfloat16)
    if route not in PROBES:
        raise SystemExit(f"no probes for the {route} route")
    K2._load()  # the forward, built from the tree as it is
    out = nvcc.BUILD_DIR / "phase_probes"
    out.mkdir(parents=True, exist_ok=True)
    src = (nvcc.CSRC / "flash_attention_bwd.cu").read_text()
    (out / "flash_attention_bwd.cu").write_text(
        probed_source(src, route, args.thread))
    nvcc.CSRC = nvcc.BUILD_DIR = out
    lib = K2._load_bwd()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(32)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    o, lse = K2.flash_attention(q, k, v, return_lse=True)
    call = (q, k, v, o, lse, do)
    K2.flash_attention_backward(*call)
    torch.cuda.synchronize()
    lib.phases_zero()
    K2.flash_attention_backward(*call)
    torch.cuda.synchronize()
    raw = (ctypes.c_ulonglong * (SLOTS * len(WALKS)))()
    if lib.phases_read(raw):
        raise RuntimeError("reading the probes failed")
    rec = {"tree": str(tree), "route": route, "device": smi,
           "thread": args.thread, "walks": {}}
    for w, walk in enumerate(WALKS):
        names = PROBES[route][walk][2]
        c = list(raw)[SLOTS * w:SLOTS * (w + 1)]
        blocks, steps = c[0], c[SLOTS - 1]
        cyc = c[1:1 + len(names)]
        total = sum(cyc)
        rec["walks"][walk] = {"blocks": blocks, "steps": steps,
                              "cycles_per_block": total / blocks,
                              "cycles_per_step": total / steps,
                              "phases": {}}
        print(f"{route} {walk} walk (thread {args.thread}): "
              f"blocks={blocks} steps={steps} "
              f"cycles_per_block={total / blocks:.0f} "
              f"cycles_per_step={total / steps:.0f}")
        for name, x in zip(names, cyc):
            rec["walks"][walk]["phases"][name] = {
                "cycles_per_block": x / blocks,
                "cycles_per_step": x / steps, "share": x / total}
            print(f"  {name:20s} cycles/block={x / blocks:10.0f} "
                  f"cycles/step={x / steps:7.0f} share={x / total:.3f}")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        K2.flash_attention_backward(*call)
    end.record()
    torch.cuda.synchronize()
    rec["ms_with_probes"] = start.elapsed_time(end) / 5
    print(f"backward ms with the probes in: {rec['ms_with_probes']:.4f}")
    print(json.dumps({"k2_bwd_phases": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
