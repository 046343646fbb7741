#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Drives the paper's delivery replay and the LM serving path through the
port's entry points, builds every kernel on those paths from the sources in
this checkout and holds each against its plain PyTorch version on the
card.  Phases, in order (any failure raises and the script exits
non-zero):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
1. build the ARIMA bank kernel (K1) with ``nvcc`` and check that ptxas
   spilled nothing in its register path;
2. K1 against its plain version on synthetic gap series, n = 4 ... 60:
   the path each shape takes, forecasts within rtol 1e-3 (bitwise equal on
   the register path), NaN positions equal, rows bitwise independent of
   the launch; 256-row and one-row kernel times (CUDA events) and one
   online forecast end to end (``ARIMA(bank=False).forecast_next``);
3. ``hpm`` on the OOI trace at scale 1.0 (main path); 3b. the k-means
   Lloyd iterations of each of its ``PlacementEngine.recluster`` calls,
   on exactly their inputs (CUDA events), and their bound;
4. ``hpm`` on the ``ooi_arima`` profile at OOI's 400 users (main path):
   every deferred series of at least 4 gaps goes through K1; then, for the
   flushes of phases 3 and 4, K1 on exactly those inputs as the main path
   launches it (every bucket in one call), compared bucket by bucket with
   its plain version and timed with CUDA events;
4c. ``md2`` on the phase 4 trace (main path): online prediction, one
   single-row K1 call per fitted request; K1 calls by bucket and the host
   seconds inside ``ARIMA.forecast_next``;
5. ``cache_only`` on the phase 3 trace;
6. online == batched on the card: ``hpm`` on a small jittered trace gives
   identical counters through the vector engine (batched K1 launches) and
   the reference engine (one padded K1 group per prediction);
7. report the builds of the flash attention (K2) and SSD scan (K3)
   kernels and their backwards (their ``nvcc`` runs, and those of the GRU
   fit (K4) and its latency probe, start with K1's in phase 1); after
   phase 8, check that ptxas spilled nothing in
   ``flash_attention_wgmma<256>`` and in K2's backward on its ``wgmma``
   and ``mma`` routes;
8. K2 against its plain version on the JAX package's ``ATTN_SWEEP`` shapes,
   ragged lengths, head dim 160, the stablelm-12b and gemma3-27b (window)
   prefill shapes, paligemma-3b's full-width attention (head dim 256, both
   types; also the generic route's time on the same inputs; and at its
   served length, 2256), arctic-480b's (56/8 heads, a group of 7),
   musicgen-large's (32/32 heads of 64 at 2064) and yi-6b's prefill: the
   route each launch took (it must be the one ``route()`` names), errors,
   kernel, plain and ``scaled_dot_product_attention`` times, bound,
   TFLOP/s, the share of the bf16 bound and the ratio to SDPA; 8b. K2's
   backward, from the forward's output and log-sum-exp, against its plain
   version (the gradient's formulas in eager float32) at yi-6b's training
   shape (4 x 2048 tokens, 32/4 heads of 128), stablelm-12b's head dim 160,
   musicgen-large's 64 (32/32 heads), gemma3-27b's window 1024,
   paligemma-3b's 256 (8/1 heads) and a reduced float32 head dim 16:
   relative L2 per gradient, two calls bitwise, the route, kernel, plain
   and SDPA backward times, the bound, the device ms of each of its CUDA
   kernels; then one yi-6b layer's attention forward and backward through
   K2 and through autograd of the plain ``attention_any`` (times, peak);
9. K3 against its plain version (the exact recurrence) on ``SSD_SWEEP``
   and the mamba2-1.3b prefill shape: the share of the bytes bound, CUDA
   kernels per call and scratch bytes; 9b. K3's backward, given the
   incoming chunk states K3's forward keeps, against its plain version
   (the same chunked decomposition in eager float32, its states
   recomputed) on both routes and at mamba2-1.3b's training shape (4 x
   2048 tokens): the route taken, relative L2 per gradient, two calls
   bitwise equal, kernel and plain times, the bound, the device time of
   each CUDA kernel of a call, scratch bytes and the forward's saved
   bytes; 9c. the AdamW update (K5, built with the others in phase 1)
   against its plain version on the card tests' tensor sets (every
   combination of float32 and bf16 parameters, gradients and moments,
   aligned and at element offsets): bit for bit where the norm is under
   the clip, with clipping the norm within 1e-6, the moments and the
   parameters within relative L2 1e-6, and bit for bit against the plain
   per-tensor formula fed the kernel's own norm; then at
   mamba2-1.3b's and yi-6b's full parameter sets once against its plain
   version, tensor by tensor (the norm and the bits fed its own norm as
   above; the distance from the plain formula at the plain norm printed),
   and its time (CUDA events),
   each CUDA kernel's device time, the bytes bound, the plain version's
   and the library's (``torch._foreach_norm`` + ``torch._fused_adamw_``)
   times; 9d. K5 on the local shards of two ranks of the one card, each a
   spawned process in one gloo group (one card cannot hold two NCCL
   ranks): mamba2-1.3b's parameter set split between them (row blocks;
   vectors and every eighth matrix replicated, counted in the norm on
   rank 0 only), the norm's total all-reduced over gloo with CUDA
   tensors between K5's sum and its finish, held to single-rank K5 on
   the whole set: the norm within 1e-7 relative, every result bit for
   bit (the norm under the clip), each replicated tensor bit for bit with
   rank 0's copy, four launches a rank; 9e. the Mamba block's kernels (K6,
   the causal conv with its SiLU over xs, B and C in one launch; K7, the D
   skip with the gated norm; K8, the decode layer's one-token state step:
   its three convs from their states, dt, the decay, the state update and
   the D skip, every state written in place; built with the
   others in phase 1) against their plain versions at mamba2-1.3b's
   training (K6 and K7 forward and backward), prefill (K6 keeping its
   states) and decode (K6 from its states, K8 from the same, K7 without
   the skip) shapes, one jamba layer's widths and the reduced widths in
   float32 and bf16: K6's forward within one ulp, K8's states bit for bit
   and its output within one bf16 ulp, two replays of a captured K8 call
   bitwise with the eager one, the rest within
   relative L2 1e-5 (float32) / 4e-3 (bf16), two calls bitwise, device
   ms (calls captured in a CUDA graph) beside the bytes bound, the plain
   version's and the previous kernels' times, each call's route (16-byte
   vectors or element by element) and its device ms by CUDA kernel (one
   traced replay of the captured calls), and the plain ops' autograd
   forward and backward; 9f. the unit's kernels (K9, the residual add
   with the next RMSNorm, with and without the add; K10, the SwiGLU gate;
   forward and backward) against their plain versions at yi-6b's and
   mamba2-1.3b's training shapes, their decode rows, deepseek-v3's
   d_model 7168, float32 and a view on the scalar route: K9's sum bit for
   bit, its norm and K10 within one ulp (bf16), the backwards' sums within
   relative L2 1e-5 (float32) / 4e-3 (bf16), two calls and two replays
   of a captured call bitwise, device ms (calls captured in a CUDA graph)
   beside the bytes bound, the plain version's and the library call's
   (``torch.nn.functional.rms_norm`` for K9 without the add; none for
   the rest), the route; phases 10-11, 18, 18b-18e, 22-23 then gate and
   report their launches (every norm K9 once, every gated FFN K10 once a
   pass);
10. serve yi-6b at full width (random weights from a seed) with
    ``ServeEngine``: three jittered recurring clients, 2000-token prompts;
    every prefill's 32 attention layers go through K2, the scheduler's
    ARIMA fit through K1; the full-width prefill through K2 agrees with
    the same prefill through K2's plain version; the engine decodes through
    its ``DecodeProgram``, one decode step captured in a CUDA graph at the
    first request and replayed per token (capture seconds; the logits
    buffer finite after every replay); then one cold request: 16 tokens
    from one prefill through the graph and through the eager per-token
    loop, unprofiled (tokens/s of each) and under ``torch.profiler``
    (prefill and both decodes: device busy share and device time by
    kernel); the graph's tokens equal the eager loop's, and the last
    step's logits are compared bit for bit;
11. serve mamba2-1.3b the same way; every prefill's 48 layers go through K3,
    K6 and K7, the decode graph's through K8 and K7 (their wrappers
    counted: once a layer in each prefill and in the graph's warm-up and
    capture; one profiled replay runs each 48 times and K6 never), every
    cache a decode step returns is the program's own buffer (no state
    copy; the replay's device-to-device copies counted), kernels and
    device ms of one decode token;
12. one stablelm-12b prefill (head dim 160) of a 2000-token prompt at full
    width: 40 K2 launches, finite logits, and the 256-token prefill through
    K2 against the same prefill through its plain version;
13. the interval engine (``run_strategy(engine="interval")``, host NumPy)
    against the vector engine on the same trace and config, counters
    identical and the planner's route as expected: (a) OOI 1.0 (fused);
    (b) 8 GB per DTN on OOI 1.0 and GAGE 1.0 (fused); (c) OOI 1.0 at 300 s
    (fused) and OOI 0.5 at 60 s chunks (sweep); (d) ``hpm`` on the phase 4
    trace, which delegates to the vector engine and launches K1, counters
    equal to phase 4's; (e) a synthesized 1M-request OOI stream
    (``benchmarks/bench_engine.py``'s full-trace settings) windowed through
    each engine in a spawned process (requests/s, peak RSS), and its
    200k-request prefix materialized == windowed.  Each line gives the
    route the interval engine took and its eviction counters;
14. K4 (the GRU fit) against its plain version, bitwise, at every bucket
    (n = 4 ... 60) on the three regimes of
    ``benchmarks/beyond_rnn_predictor.py`` (40 histories each, one
    120-row call per bucket on each side); at n = 60 one row's kernel and
    plain times, one ``GRUPredictor.forecast_next`` end to end, the
    operations bound and the chain-latency bound (the latencies of the
    step's critical path probed on the card by
    ``csrc/gru_latency_probe.cu``, at its maximum SM clock);
15. ``beyond_rnn_predictor.run`` through the port (main path of K4): 3
    regimes x 40 forecasts through ``predict_next_timestamp_rnn`` (K4) and
    ``predict_next_timestamp`` (K1): mean relative errors, microseconds per
    forecast, launches;
16. K2 and K3 on their generic routes (the reduced configs' head dims
    8-20; N, P = 16, 16 and 16, 64) against their plain versions: the
    route taken, errors, times, SDPA, bounds;
17. ``launch/serve.py --reduced --device cuda`` for all ten configs
    (yi-6b, starcoder2-7b, stablelm-12b, gemma3-27b, mamba2-1.3b,
    deepseek-v3-671b, arctic-480b, jamba-1.5-large-398b, musicgen-large,
    paligemma-3b): K2 launches where a config has GQA attention, K3 where
    it has Mamba layers (deepseek-v3's MLA launches neither), every one on
    the generic route, and one prefill through the kernels against the same
    prefill through their plain versions (each engine decodes through its
    captured graph);
18. training on the card, the SSD through K3 and attention through K2,
    each forward and backward (autograd Functions), each ``train_loop``
    step after the first a replay of one captured CUDA graph: (a) one
    float32 ``make_train_step`` step of reduced yi-6b, mamba2-1.3b,
    deepseek-v3 (MLA, MoE, MTP, aux loss) and jamba on the card against
    the CPU (loss within rtol 1e-4, the first moment within 1e-3 relative
    L2); (b) ``train_loop`` on mamba2-1.3b at full width and depth, bf16,
    ``SyntheticLM`` through ``PrefetchingLoader``, 4 x 2048 tokens a step,
    6 steps: losses and grad norms finite and no step skipped, K3's, K6's
    and K7's forward and backward wrappers called 96 and 48 times a step
    (in the eager warm-up step and in the captured one), and a profiled
    replay's kernel table holding 96 and 48 calls of each (a trace that
    lacks any is
    taken again, up to 3, and the numbers reported are those of the trace
    that passed); the launches reported are
    those executed (warm-up and replays); step time, tokens/s,
    6·N·T per step time as a share of 989 TFLOP/s, peak memory and the
    loader's stats; then in the same run eager steps and replays of a
    captured ``TrainProgram``, each with its wall time, tokens/s, 6·N·T
    share, peak memory and the busy share and kernels of one step profiled
    tracing the card only; the graph step's device time by op (K5, K3,
    K6 and K7 forward and backward, GEMMs, the largest other kernels by
    name, the
    in-place AdamW update timed alone on a copy of the state) and one
    layer's SSD at the training shape forward and backward through K3
    and through autograd of the plain ``ssd_chunked``; every update runs
    in place through K5 (three CUDA kernels a step, counted in the
    replay), peak memory printed beside the state's bytes, and the loss
    must fall; (c) the same for yi-6b at full width with its 32 layers
    cut to 4 (no K3 launch; K2 forward 8 and backward 4 a step, twice
    each layer's forward with the remat recompute); (e) yi-6b at full
    width and depth (6.06B parameters) with bf16 moments, ``train_loop``
    only (a functional step would hold two copies of the state; K2
    forward 64 and backward 32 a step), then one profiled replay of a
    captured program: step time, tokens/s, 6·N·T share, peak
    allocated and reserved memory, busy share, and the update timed
    alone on the state itself; (d) a checkpoint at step 2 resumed to
    step 4 on a reduced config, bitwise equal to restoring by hand, then
    ``python -m repro_torch.launch.train --arch yi-6b --reduced --steps
    3`` on the card by default;
19. deepseek-v3-671b at full width, 4 of 61 layers (3 dense MLA layers,
    one MLA/MoE unit and the MTP layer ``init_params`` builds; ~50 GiB of
    random weights), served as in phase 10: no K2/K3 launch (MLA's
    attention and the experts are plain paths), K1 schedules; TTFT, decode
    rate, peak memory, busy shares; the share of routed slots dropped over
    capacity in a cold prefill and a decode step; a teacher-forced decode
    of one token against the prefill of the extended prompt;
20. paligemma-3b at full width and depth served as in phase 10 (2000-token
    prompts after 256 zero prefix embeddings): 18 K2 launches a prefill,
    all on ``wgmma`` at head dim 256, and a 256-token prefill through K2
    against its plain version;
21. one 2000-token prefill each of (a) arctic-480b at full width, 1 of 35
    layers (one K2 launch on ``wgmma``, 56/8 heads: a group of 7) and (b)
    musicgen-large at full width and depth (48 launches on ``wgmma`` at
    head dim 64 after 64 prefix positions, 4 codebooks), each checked
    against the plain version as in phase 20; musicgen then decodes 8
    steps through a captured ``DecodeProgram`` and through the eager loop,
    tokens equal.  A ``phases 19-21 summary:`` JSON line follows phase 21;
22. the multi-device layer on a 1 x 1 (data, model) mesh over NCCL at
    world size 1: yi-6b at full width, 4 of 32 layers, trained through
    ``train_loop(..., mesh=mesh)`` on phase 18c's traffic (4 x 2048 tokens)
    for 3 steps: the sharded init (each leaf placed as it is drawn), then
    the mesh program (an eager warm-up, one step captured in a CUDA graph
    and replayed: DTensor's redistributions, K5's four kernels on the
    local shards, norm, sum, then after the all-reduce finish and
    update); its losses and grad norms bit for bit equal to the no-mesh
    loop's on the same batches, K5's wrapper called in the warm-up and
    the capture (8 kernels), a profiled replay running K5's four kernels
    once each; the step time beside phase 18c's, the busy share, one
    eager mesh step beside the replay, K5's mesh call timed alone beside
    the call without the mesh and the bound, and the peak memory; then a
    checkpoint of the mesh's state restored into its placements,
    bitwise; 22b. yi-6b at full width and depth with bf16 moments
    through ``train_loop(..., mesh=mesh)`` for 3 steps (one copy of its
    state, as 18e): losses and grad norms bit for bit equal to 18e's
    first three, every parameter a DTensor, the first step's peak (the
    init included) within 2 GiB of what a replayed step holds, K5's mesh
    call timed; 22c. mamba2-1.3b at full width and depth through
    ``train_loop(..., mesh=mesh)`` for 3 steps on 18b's batches: losses
    and grad norms bit for bit equal to 18b's first three, a profiled
    replay running K3, K6 and K7 forward 96 and backward 48 times and
    K5's four kernels once each, one eager mesh step beside it;
23. serve placements on the same mesh: yi-6b and mamba2-1.3b at full width
    and depth prefill a 2000-token prompt as DTensors under the decode
    cache hints, then decode 4 tokens: one K2 (K3, K6 and K7) launch per
    layer on the fast route through ``local_map`` (``kernels.ops.per_rank``:
    once an attention layer, three times a Mamba layer; 32 K2 and 144 =
    48 x 3 K3 CUDA kernels in a traced prefill; a trace that holds another
    count is taken again, up to three), logits
    against the no-mesh prefill and decode; then one MoE layer of
    deepseek-v3-671b at full width (256 experts of 7168 x 2048, top-8,
    ~22.5 GB of bf16 weights) through ``moe_apply_ep`` in train and serve
    mode against ``moe_apply`` on the same 2000 tokens;
24. ``compressed_all_reduce`` on a 1 x 1 x 1 (pod, data, model) mesh over
    NCCL: each element within half its block's scale plus the bf16
    payload's rounding; then the roofline terms (H100 datasheet peaks) and
    the measured roofline fraction of phases 18b, 18c, 22 and 22c's steps
    and
    of phase 23's no-mesh prefills (phases 10-11's configuration), by
    device time and by wall time.  A ``phases 22-24 summary:`` JSON line
    follows phase 24.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py

``--only k2 k3 k4 k5 mamba unit`` (any of them) runs only phase 0, the
named kernels' builds and their phases (7-8b for K2 and its backward, 9-9b
for K3 and its
backward, 9c-9d for K5, 9e for K6, K7 and K8, 9f for K9 and K10, 14 for
K4), then prints
their records as ``{"kernels": [...]}`` and
no ``ok`` line: a quick way to time the kernels of two checkouts in one call,
by copying this script (and ``src/repro_torch/csrc/gru_latency_probe.cu``,
for K4) into the other.  ``--only mesh`` builds K2, K3, K5, K6, K7, K9 and
K10 and runs
phases 18b, 18c and 18e (what the mesh phases are held to), then 22, 22b
and 22c.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, dense
# float32 outside the tensor cores and dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

RTOL = 1e-3     # kernel vs plain: the Adam trajectory amplifies ulps
# torch.profiler keeps only the kernel records that fall inside its trace
# window, whose edges it places by the host clock; a trace now and then
# lost the records of a step's first ~2.4 ms (scripts/trace_records.py) or
# its last kernel.  Traces leave this much idle time at either end.
TRACE_PAD_S = 0.05
STEPS, LR = 200, 0.05
ARIMA_USERS = 400   # users of the ooi_arima trace (phases 4-4c)
REFINED_PAIRS = 1 << 30   # operand pairs of phase 2's division check


_T0 = time.perf_counter()


def log(*args) -> None:
    """Print a line; a phase's header (``== ...``) also gets the seconds
    since the script started."""
    if args and str(args[0]).startswith("== "):
        args = (*args, f"[t={time.perf_counter() - _T0:.0f}s]")
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def counters(res) -> tuple:
    agg = res.outcome_totals()
    return (res.origin_requests, res.prefetch_issued_chunks,
            res.prefetch_used_chunks, res.stream_pushes,
            tuple(sorted((d, s.hits, s.misses, s.evictions, s.inserted_bytes)
                         for d, s in res.cache_stats.items())),
            agg.n, agg.bytes, agg.local_bytes, agg.prefetched_bytes,
            agg.peer_bytes, agg.origin_bytes)


def check_result(res, n_requests: int) -> None:
    """What a replay must satisfy whatever the strategy."""
    agg = res.outcome_totals()
    if res.total_requests != n_requests or agg.n != n_requests:
        raise AssertionError(f"{res.name}: replayed {agg.n} of {n_requests}")
    if agg.local_bytes + agg.prefetched_bytes + agg.peer_bytes + \
            agg.origin_bytes > agg.bytes:
        raise AssertionError(f"{res.name}: byte split exceeds request bytes")
    for v in (res.mean_throughput_mbps, res.mean_latency_s, res.recall):
        if not math.isfinite(v):
            raise AssertionError(f"{res.name}: non-finite metric {v}")


def compare(kernel, plain) -> dict:
    """Kernel vs plain forecasts: NaN positions equal, finite values within
    RTOL; returns the errors and the number of bitwise-equal rows."""
    import torch
    kn, pn = torch.isnan(kernel), torch.isnan(plain)
    if not torch.equal(kn, pn):
        raise AssertionError("K1: NaN positions differ from the plain version")
    ok = ~kn
    diff = (kernel[ok] - plain[ok]).abs()
    scale = plain[ok].abs().clamp_min(1e-30)
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float((diff / scale).max()) if diff.numel() else 0.0
    bad = int((diff > RTOL * scale).sum())
    if bad:
        raise AssertionError(f"K1: {bad} rows outside rtol {RTOL} "
                             f"(max rel {rel_err:.3g})")
    bitwise = int((kernel.view(torch.int32) == plain.view(torch.int32)).sum())
    return {"max_abs_err": abs_err, "max_rel_err": rel_err,
            "bitwise_rows": bitwise, "rows": int(kernel.numel())}


def _sync(dev):
    import torch
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean time of ``fn`` on the card (CUDA events, after one warm-up
    unless the caller has just run it)."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_work(rows: int, n: int, p: int = 2, d: int = 1, q: int = 1,
            steps: int = STEPS) -> tuple[int, int]:
    """(bytes, float32 operations) one K1 launch needs for rows x n.

    Bytes: each input read once, each forecast written once.  Operations
    per row: normalise (~6n), then per Adam step a forward recursion
    (2p + 2q + 2 per time step), the reverse recursion (2q + 2p + 2q + 4
    per time step) and 14 per parameter of Adam, then a last forward pass
    and the forecast."""
    N = n - d
    per_step = N * (2 * p + 2 * q + 2) + N * (2 * p + 4 * q + 4) \
        + 14 * (1 + p + q)
    per_row = (6 * n + steps * per_step + N * (2 * p + 2 * q + 2)
               + 2 * (p + q) + 2 * d + 2)
    return rows * n * 4 + rows * 4, rows * per_row


def bound_ms(work: list[tuple[int, int]]) -> tuple[float, str]:
    nbytes = sum(b for b, _ in work)
    flops = sum(f for _, f in work)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def k1_shape_times(K, T_arima, y, dev, time_ms) -> tuple[float, ...]:
    """K1 at order (2, 1, 1) on rows ``y [rows, n]``: the kernel's time
    for all rows and for the first row alone (``time_ms``), and one online
    ``forecast_next`` of the first row end to end (copy in, launch, copy
    out and synchronise; host clock).  It calls only ``arima_bank`` and
    ``ARIMA.forecast_next``, which every version of the port has, so
    ``scripts/k1_compare.py`` times older trees with it too."""
    order = (2, 1, 1)
    k_ms = time_ms(lambda: K.arima_bank(y, order, STEPS, LR), reps=5)
    y1 = y[:1].contiguous()
    one_ms = time_ms(lambda: K.arima_bank(y1, order, STEPS, LR), reps=50)
    model = T_arima.ARIMA(n=60, bank=False, device=dev)
    series = y1[0].cpu().numpy()
    model.forecast_next(series)
    t0 = time.perf_counter()
    for _ in range(50):
        model.forecast_next(series)
    return k_ms, one_ms, (time.perf_counter() - t0) / 50 * 1e3


def phase_k1_synthetic(torch, K, T_arima, np, dev, time_ms) -> dict:
    """Phase 2; returns the single-row n=60 times (kernel and end to
    end)."""
    log("== phase 2: K1 vs plain on synthetic gap series")
    if dev.type == "cuda":
        div_bad, sqrt_bad = K.refined_mismatches(REFINED_PAIRS, 20261017,
                                                 dev)
        log(f"register path division and square root vs IEEE: "
            f"pairs={REFINED_PAIRS} division_mismatches={div_bad} "
            f"square_root_mismatches={sqrt_bad} (every float in range)")
        if div_bad or sqrt_bad:
            raise AssertionError("K1: the register path's division or "
                                 "square root is not the IEEE operation")
    rng = np.random.default_rng(20261016)
    order = (2, 1, 1)
    single = {}
    for n in (4, 8, 16, 32, 60):
        y = torch.from_numpy(rng.normal(3600.0, 400.0, size=(256, n))
                             .astype(np.float32)).to(dev)
        path = K.route(order, n)
        got = K.arima_bank(y, order, STEPS, LR)
        want = K.arima_fit_plain(y, order, STEPS, LR)
        _sync(dev)()
        cmp = compare(got, want)
        if path == "register" and cmp["bitwise_rows"] != cmp["rows"]:
            raise AssertionError(f"K1 n={n}: the register path differs from "
                                 f"the plain version in "
                                 f"{cmp['rows'] - cmp['bitwise_rows']} rows")
        p_ms = time_ms(lambda: K.arima_fit_plain(y, order, STEPS, LR),
                       reps=1, warmup=False)
        k_ms, one_ms, call_ms = k1_shape_times(K, T_arima, y, dev, time_ms)
        single[n] = (one_ms, call_ms)
        # rows are independent of the launch: alone, reversed, full batch
        rev = K.arima_bank(y.flip(0).contiguous(), order, STEPS, LR)
        alone = torch.cat([K.arima_bank(y[i:i + 1].contiguous(), order,
                                        STEPS, LR) for i in range(0, 256, 37)])
        bits = got.view(torch.int32)
        if not (torch.equal(bits, rev.flip(0).view(torch.int32))
                and torch.equal(bits[::37], alone.view(torch.int32))):
            raise AssertionError(f"K1 n={n}: rows depend on the launch")
        log(f"n={n:2d} path={path} rows=256 kernel_ms={k_ms:.4f} "
            f"one_row_kernel_ms={one_ms:.4f} one_row_forecast_next_ms="
            f"{call_ms:.4f} plain_ms={p_ms:.1f} "
            f"library_ms=null max_abs_err={cmp['max_abs_err']:.6g} "
            f"max_rel_err={cmp['max_rel_err']:.3g} "
            f"bitwise_equal_rows={cmp['bitwise_rows']}/256 "
            f"row_independent=True")
    t = np.arange(40, dtype=np.float64)
    quad = (3.0 + 2.0 * t + 0.5 * t * t).astype(np.float32)[-32:]
    yq = torch.from_numpy(quad[None, :].copy()).to(dev)
    got = K.arima_bank(yq, (1, 2, 0), STEPS, LR)
    want = K.arima_fit_plain(yq, (1, 2, 0), STEPS, LR)
    cmp = compare(got, want)
    expect = float(quad[-1]) + float(quad[-1] - quad[-2]) + \
        float(np.diff(quad.astype(np.float64), n=2)[-1])
    if abs(float(got[0]) - expect) > 1e-2 * abs(expect):
        raise AssertionError(f"K1 d=2: {float(got[0])} vs {expect}")
    log(f"d=2 quadratic: path={K.route((1, 2, 0), 32)} "
        f"kernel={float(got[0]):.6f} "
        f"plain={float(want[0]):.6f} numpy_extrapolation={expect:.6f} "
        f"max_abs_err={cmp['max_abs_err']:.6g}")
    return {"single_row_kernel_ms": single[60][0],
            "single_row_forecast_next_ms": single[60][1]}


def record_calls(cls, name: str):
    """Wrap method ``name`` of ``cls`` to keep ``(self, first argument,
    seconds)`` of every call; returns the list and a function that
    restores the method.  Used on ``ARIMA.batched_forecast`` (the series
    the planner defers: the kernel's inputs), ``HPMAdapter.plan`` and
    ``ARIMA.forecast_next`` (``md2``'s online fits)."""
    calls: list = []
    inner = getattr(cls, name)

    def recording(self, arg):
        t0 = time.perf_counter()
        out = inner(self, arg)
        calls.append((self, arg, time.perf_counter() - t0))
        return out

    setattr(cls, name, recording)
    return calls, lambda: setattr(cls, name, inner)


def log_split(name: str, total: float, plans: list, flushes: list) -> None:
    """Host-clock split of one replay: the planner (its bank flush apart)
    and the engine with everything else."""
    plan_s = sum(t for _, _, t in plans)
    flush_s = sum(t for _, _, t in flushes)
    log(f"{name} split: total_seconds={total:.3f} planner_seconds="
        f"{plan_s - flush_s:.3f} bank_flush_seconds={flush_s:.3f} "
        f"engine_and_rest_seconds={total - plan_s:.3f}")


def record_kmeans(np):
    """Wrap the k-means that ``PlacementEngine.recluster`` calls to keep
    ``(features, k, seed)`` of every call; returns the list and a function
    that restores it."""
    from repro_torch.core import placement as P
    calls: list = []
    inner = P.kmeans

    def recording(x, k, *args, **kw):
        calls.append((np.asarray(x, np.float32).copy(), k, kw.get("seed", 0)))
        return inner(x, k, *args, **kw)

    P.kmeans = recording
    return calls, lambda: setattr(P, "kmeans", inner)


def kmeans_phase(torch, np, calls, dev) -> dict:
    """Phase 3b: the Lloyd iterations (``core/kmeans.py::_lloyd``, eager
    torch ops on the card) of every ``PlacementEngine.recluster`` of the
    phase 3 replay, on exactly its inputs, timed with CUDA events; their
    bound (bytes: features, centres in and out, assignments; operations:
    ~5 n k dim + 2 n k per iteration)."""
    import importlib
    # the module, not the function repro_torch.core re-exports under its name
    KM = importlib.import_module("repro_torch.core.kmeans")
    iters = 25                      # kmeans()'s default, which recluster uses
    total_ms, work, shapes = 0.0, [], {}
    for x, k, seed in calls:
        k = min(k, len(x))
        c0 = KM._kmeanspp_init(x, k, np.random.default_rng(seed))
        xt = torch.from_numpy(x).to(dev)
        ct = torch.from_numpy(c0).to(dev)
        total_ms += cuda_ms(lambda: KM._lloyd(xt, ct, k, iters), reps=3)
        n, dim = x.shape
        shapes[(n, k, dim)] = shapes.get((n, k, dim), 0) + 1
        work.append((n * dim * 4 + 2 * k * dim * 4 + n * 8 + 4,
                     (iters + 1) * (5 * n * k * dim + 2 * n * k)))
    nbytes = sum(b for b, _ in work)
    bound, by = bound_ms(work)
    rec = {"calls": len(calls),
           "ms_per_recluster": total_ms / max(len(calls), 1),
           "ms_per_replay": total_ms, "bound_ms_per_replay": bound,
           "bound_by": by,
           "bytes_bound_ms_per_replay": nbytes / HBM_BYTES_PER_S * 1e3}
    log(f"ooi hpm k-means: recluster_calls={rec['calls']} lloyd_ms_per_"
        f"recluster={rec['ms_per_recluster']:.4f} lloyd_ms_per_replay="
        f"{total_ms:.3f} bound_ms_per_replay={bound:.6f} ({by}) "
        f"bytes_bound_ms_per_replay={rec['bytes_bound_ms_per_replay']:.6f} "
        f"shapes_n_k_dim={dict(sorted(shapes.items())[:6])}")
    if not calls:
        raise AssertionError("ooi hpm: PlacementEngine never reclustered")
    return rec


def run_main_path(T, K, name, test, train, profile, dev, strategy="hpm",
                  engine="vector"):
    cfg = T.SimConfig(stream_rate_bytes_per_s=profile.bytes_per_second_stream,
                      cache_bytes=128 << 30, chunk_seconds=3600.0
                      ).calibrate_origin(test)
    sync = _sync(dev)
    sync()
    K.reset_counts()                      # counts of this run only
    t0 = time.perf_counter()
    res = T.run_strategy(strategy, test, profile.grid, cfg, train,
                         engine=engine, device=dev)
    sync()
    dt = time.perf_counter() - t0
    launches, rows = K.LAUNCHES, K.ROWS
    check_result(res, len(test))
    log(f"{name} {strategy}: requests={len(test)} seconds={dt:.3f} "
        f"requests_per_s={len(test) / dt:.1f} K1_launches={launches} "
        f"K1_rows={rows}")
    log(f"{name} {strategy} counters: {counters(res)}")
    log(f"{name} {strategy} metrics: throughput_mbps="
        f"{res.mean_throughput_mbps:.6g} latency_s={res.mean_latency_s:.6g} "
        f"recall={res.recall:.6g} origin_frac="
        f"{res.normalized_origin_requests:.6g}")
    return res, launches, rows, dt


def ooi_arima_trace(T, users: int):
    """The ``ooi_arima`` profile (``benchmarks/bench_engine.py:74-77``:
    program periods jittered past the median fast path) at ``users``
    users, and its seeded trace split 30/70: ``(profile, train, test)``."""
    profile = dataclasses.replace(
        T.OOI_PROFILE, name="ooi_arima", n_users=users,
        human_user_frac=0.25,
        type_volume_mix=(0.85, 0.05, 0.10), period_jitter_frac=0.06,
        duration=7 * 24 * 3600.0)
    t0 = time.perf_counter()
    tr = T.TraceGenerator(profile, seed=0).generate()
    cut = int(len(tr) * 0.3)
    log(f"trace seconds={time.perf_counter() - t0:.2f} requests={len(tr)}")
    return profile, tr[:cut], tr[cut:]


def run_md2(T, T_arima, K, name, test, train, profile, dev) -> dict:
    """``md2`` through the vector engine.  It predicts online: each request
    of a user with at least 4 gaps that misses the median fast path makes
    one single-row K1 call (``ARIMA(bank=False).forecast_next``).  Prints
    K1 calls by history bucket and the host seconds spent inside
    ``forecast_next`` (copies, launch and synchronisation included)."""
    calls, restore = record_calls(T_arima.ARIMA, "forecast_next")
    try:
        _, launches, _, dt = run_main_path(T, K, name, test, train, profile,
                                           dev, strategy="md2")
    finally:
        restore()
    by_bucket: dict[int, int] = {}
    for model, series, _ in calls:
        if len(series) >= 4:
            n = model._bucket(len(series))
            by_bucket[n] = by_bucket.get(n, 0) + 1
    fitted = sum(by_bucket.values())
    host_s = sum(t for _, _, t in calls)
    log(f"{name} md2: K1_calls={fitted} K1_calls_by_bucket="
        f"{dict(sorted(by_bucket.items()))} forecast_next_calls={len(calls)} "
        f"forecast_next_host_seconds={host_s:.3f} "
        f"share_of_replay={host_s / dt:.3f} "
        f"ms_per_K1_call={host_s / max(fitted, 1) * 1e3:.4f}")
    if launches == 0 or launches != fitted:
        raise AssertionError(f"{name} md2: {launches} K1 launches for "
                             f"{fitted} fits")
    return {"requests": len(test), "seconds": dt, "launches": launches,
            "by_bucket": by_bucket, "forecast_next_seconds": host_s}


def k1_on_flush(torch, np, K, T_arima, name, calls, rows_launched, dev,
                time_ms) -> dict:
    """Check that every deferred series of >= 4 gaps of one replay went
    through K1 (one row each, in groups of ``BANK_WIDTH``), then run K1 on
    exactly those inputs as the main path launches them (every bucket in
    one call, ``pack_bank``): compare each bucket with its plain version,
    time the one call and, as information, each bucket's own launch."""
    series = [np.asarray(s, np.float32) for _, sl, _ in calls for s in sl]
    fitted = [s for s in series if s.size >= 4]
    model = calls[0][0]
    buckets: dict[int, list] = {}
    for s in fitted:
        n = model._bucket(s.size)
        buckets.setdefault(n, []).append(s[-n:])
    flat, table = T_arima.pack_bank(buckets)
    padded = sum(rows for _, rows, _ in table)
    if rows_launched != padded:
        raise AssertionError(f"{name}: K1 rows {rows_launched} != {padded}")
    log(f"{name}: deferred_series={len(series)} "
        f"with_4_or_more_gaps={len(fitted)} K1_rows_padded={rows_launched} "
        f"buckets={ {n: len(v) for n, v in sorted(buckets.items())} } "
        f"segments={table}")
    o = model.order
    order, steps, lr = (o.p, o.d, o.q), model.steps, model.lr
    y = torch.from_numpy(flat).to(dev)
    got = K.arima_bank_segments(y, table, order, steps, lr)
    ms = time_ms(lambda: K.arima_bank_segments(y, table, order, steps, lr),
                 reps=20)
    rec = {"ms": ms, "plain_ms": 0.0, "max_abs_err": 0.0,
           "max_rel_err": 0.0, "bitwise_rows": 0, "rows": 0}
    work = []
    for row0, _, n in table:
        yb = torch.from_numpy(np.stack(buckets[n])).to(dev)
        out = {}

        def plain():
            out["want"] = K.arima_fit_plain(yb, order, steps, lr)

        plain_ms = time_ms(plain, reps=1, warmup=False)
        cmp = compare(got[row0:row0 + len(yb)], out["want"])
        own_ms = time_ms(lambda: K.arima_bank(yb, order, steps, lr), reps=3)
        rec["plain_ms"] += plain_ms
        work.append(k1_work(len(yb), n, *order, steps=steps))
        for key in ("max_abs_err", "max_rel_err"):
            rec[key] = max(rec[key], cmp[key])
        rec["bitwise_rows"] += cmp["bitwise_rows"]
        rec["rows"] += cmp["rows"]
        log(f"{name} bucket n={n}: path={K.route(order, n)} rows={len(yb)} "
            f"own_launch_kernel_ms={own_ms:.4f} plain_ms={plain_ms:.1f} "
            f"max_abs_err={cmp['max_abs_err']:.6g} "
            f"max_rel_err={cmp['max_rel_err']:.3g} "
            f"bitwise_equal_rows={cmp['bitwise_rows']}/{len(yb)}")
    rec["bound_ms"], rec["bound_by"] = bound_ms(work)
    log(f"{name} K1 over the flush, one launch: kernel_ms={ms:.4f} "
        f"plain_ms={rec['plain_ms']:.1f} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']}) kernel_over_bound={ms / rec['bound_ms']:.2f} "
        f"bitwise_equal_rows={rec['bitwise_rows']}/{rec['rows']}")
    return rec


def drive(torch, np, T, T_arima, K, dev, ooi_scale: float = 1.0,
          arima_users: int = ARIMA_USERS, time_ms=cuda_ms
          ) -> tuple[list, dict]:
    """Phases 2-6 on ``dev``; returns the ``kernels`` records and what
    phase 13 reuses: the OOI and ``ooi_arima`` splits and phase 4's
    counters."""
    single = phase_k1_synthetic(torch, K, T_arima, np, dev, time_ms)
    seen, restore_bank = record_calls(T_arima.ARIMA, "batched_forecast")
    plans, restore_plan = record_calls(T.HPMAdapter, "plan")

    log(f"== phase 3: hpm on OOI, scale {ooi_scale}")
    t0 = time.perf_counter()
    ooi = T.make_trace("ooi", seed=0, scale=ooi_scale)
    cut = int(len(ooi) * 0.3)
    ooi_train, ooi_test = ooi[:cut], ooi[cut:]
    log(f"trace seconds={time.perf_counter() - t0:.2f} requests={len(ooi)}")
    km_calls, restore_km = record_kmeans(np)
    _, launches3, rows3, dt3 = run_main_path(T, K, "ooi", ooi_test,
                                             ooi_train, T.OOI_PROFILE, dev)
    restore_km()
    if launches3 == 0 or not seen:
        raise AssertionError("ooi hpm: K1 never ran")
    log_split("ooi hpm", dt3, plans, seen)
    flush3 = list(seen)
    log("== phase 3b: k-means per PlacementEngine.recluster (OOI hpm)")
    kmeans_phase(torch, np, km_calls, dev)

    log(f"== phase 4: hpm on ooi_arima, {arima_users} users")
    profile, train, test = ooi_arima_trace(T, arima_users)
    seen.clear()
    plans.clear()
    res4, launches4, rows4, dt4 = run_main_path(T, K, "ooi_arima", test,
                                                train, profile, dev)
    restore_bank()
    restore_plan()
    if launches4 == 0 or not seen:
        raise AssertionError("ooi_arima hpm: K1 never ran")
    log_split("ooi_arima hpm", dt4, plans, seen)

    log("== phase 4b: K1 vs plain on the main path's inputs")
    k3 = k1_on_flush(torch, np, K, T_arima, "ooi hpm", flush3, rows3, dev,
                     time_ms)
    k4 = k1_on_flush(torch, np, K, T_arima, "ooi_arima hpm", seen, rows4,
                     dev, time_ms)

    log(f"== phase 4c: md2 on ooi_arima, {arima_users} users (online K1)")
    md2 = run_md2(T, T_arima, K, "ooi_arima", test, train, profile, dev)

    log("== phase 5: cache_only on the OOI trace")
    run_main_path(T, K, "ooi", ooi_test, ooi_train, T.OOI_PROFILE, dev,
                  strategy="cache_only")

    log("== phase 6: online == batched on the card (hpm, small trace)")
    small = dataclasses.replace(profile, n_users=6, human_user_frac=0.2,
                                type_volume_mix=(0.9, 0.05, 0.05))
    tr = T.TraceGenerator(small, seed=3).generate()
    cut = int(len(tr) * 0.3)
    res = {}
    for engine in ("vector", "reference"):
        cfg = T.SimConfig(stream_rate_bytes_per_s=small.bytes_per_second_stream
                          ).calibrate_origin(tr[cut:])
        K.reset_counts()
        res[engine] = T.run_strategy("hpm", tr[cut:], small.grid, cfg,
                                     tr[:cut], engine=engine, device=dev)
        log(f"{engine}: K1_launches={K.LAUNCHES} "
            f"counters={counters(res[engine])}")
    if counters(res["vector"]) != counters(res["reference"]):
        raise AssertionError("hpm: vector and reference engines disagree")

    reuse = {"ooi": (ooi_train, ooi_test),
             "ooi_arima": (profile, train, test),
             "ooi_arima_hpm": (counters(res4), dt4)}
    # the ooi_arima cell is the one whose flush fills the card; the OOI
    # cell's numbers ride along under the *_ooi keys, md2's online calls
    # under *_md2 and single_row_*
    return [{
        "name": "arima_bank",
        "route": "cuda",
        "source": "src/repro_torch/csrc/arima_bank.cu",
        "replaces": "src/repro/core/arima.py:181 (_compiled_bank, "
                    "jit(vmap(_build_fit)))",
        "path": K.route((2, 1, 1), 60),
        "launches": launches4,
        "max_abs_err": max(k3["max_abs_err"], k4["max_abs_err"]),
        "max_rel_err": max(k3["max_rel_err"], k4["max_rel_err"]),
        "bitwise_rows": k4["bitwise_rows"],
        "rows": k4["rows"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": None,
        **single,
        "launches_ooi": launches3,
        "ms_ooi": k3["ms"],
        "plain_ms_ooi": k3["plain_ms"],
        "bound_ms_ooi": k3["bound_ms"],
        "launches_md2": md2["launches"],
        "seconds_md2": md2["seconds"],
    }], reuse


def log_build(name: str, diag: str, seconds: float) -> dict[str, int]:
    """The build time and, per kernel entry and per device function that
    is not inlined (K1's paths), ptxas's registers and spills (the mangled
    name names the function and its template arguments).  Returns the
    spill-store bytes by function."""
    log(f"{name} build seconds={seconds:.2f}")
    entry, spills = "", {}
    for line in diag.splitlines():
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            entry = line.split("'")[1] if "'" in line else line.split()[-1]
            # drop the anonymous namespace's mangled prefix (nvcc nests it
            # in an _INTERNAL_ one for device functions), keep the name and
            # its template arguments
            entry = re.sub(r"^_ZN(\d+_INTERNAL_\w+?_cu_[0-9a-f]{8})?"
                           r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", entry)
        elif "registers" in line or "spill" in line:
            log(f"{name} ptxas: {entry[:60]}: {line.strip()}")
            stores = re.search(r"(\d+) bytes spill stores", line)
            if stores:
                spills[entry] = int(stores.group(1))
    return spills


# ---------------------------------------------------------------------------
# phases 8-11: the LM serving path (K2, K3)
# ---------------------------------------------------------------------------


def roofline(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """Least time (ms) for ``nbytes`` of HBM traffic and ``flops`` at the
    published peak of the inputs' type, and which of the two bounds it."""
    import torch
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def close(name: str, got, want, tol: float) -> tuple[float, float]:
    """(max abs error, max of error / allowance); raise unless every element
    is finite and within ``tol + tol * |want|`` (numpy's allclose with
    atol = rtol = tol)."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ratio = float((diff / (tol + tol * w.abs())).max())
    if not ratio <= 1.0 or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: outside tol {tol} (max abs err "
                             f"{float(diff.max()):.3g}, {ratio:.3g} of the "
                             f"allowance)")
    return float(diff.max()), ratio


# b, s, hq, hkv, d, window, dtype name, tol: the JAX package's ATTN_SWEEP
# (tests/test_kernels.py), S=1 and S=33, head dim 160 in float32, the
# prefills of a 2000-token prompt of stablelm-12b (head dim 160) and of
# gemma3-27b's local layers (window 1024), paligemma-3b's full-width
# attention (8/1 heads of 256, `src/repro/configs/multimodal.py`) in both
# types and at its served length (2000 tokens after 256 prefix positions),
# arctic-480b's (56/8 heads of 128: a group of 7), musicgen-large's (32/32
# heads of 64 at 2000 + 64 prefix positions), then yi-6b's (the main
# path's shape, last)
ATTN_SHAPES = [
    (1, 256, 2, 2, 128, None, "float32", 2e-5),
    (2, 256, 4, 2, 128, None, "float32", 2e-5),
    (1, 512, 4, 1, 128, None, "float32", 2e-5),
    (1, 256, 2, 2, 128, 128, "float32", 2e-5),
    (1, 512, 8, 2, 128, 256, "float32", 2e-5),
    (1, 256, 2, 2, 128, None, "bfloat16", 2e-2),
    (2, 384, 6, 2, 128, None, "float32", 2e-5),
    (1, 1, 4, 1, 64, None, "float32", 2e-5),
    (1, 33, 8, 2, 128, 16, "bfloat16", 2e-2),
    (1, 256, 4, 2, 160, None, "float32", 2e-5),
    (1, 2000, 32, 8, 160, None, "bfloat16", 2e-2),
    (1, 2000, 32, 16, 128, 1024, "bfloat16", 2e-2),
    (1, 2048, 8, 1, 256, None, "bfloat16", 2e-2),
    (1, 2048, 8, 1, 256, None, "float32", 2e-5),
    (1, 2256, 8, 1, 256, None, "bfloat16", 2e-2),
    (1, 2000, 56, 8, 128, None, "bfloat16", 2e-2),
    (1, 2064, 32, 32, 64, None, "bfloat16", 2e-2),
    (1, 2000, 32, 4, 128, None, "bfloat16", 2e-2),
]

# bt, s, h, p, g, n, dtype name, tol: SSD_SWEEP, then mamba2-1.3b's prefill
# of a 2000-token prompt padded to its 256 chunk (the main path's shape)
SSD_SHAPES = [
    (1, 256, 2, 128, 1, 128, "float32", 1e-3),
    (2, 256, 4, 128, 2, 128, "float32", 1e-3),
    (1, 512, 2, 128, 1, 128, "float32", 1e-3),
    (1, 256, 2, 128, 1, 128, "bfloat16", 5e-2),
    (2, 300, 4, 64, 2, 128, "bfloat16", 5e-2),
    (1, 2048, 64, 64, 1, 128, "bfloat16", 5e-2),
]


def live_pairs(s: int, window) -> int:
    """(query, key) pairs the causal (and window) mask lets through."""
    if window is None:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def launched_route(mod, fn, named: str):
    """Run ``fn``, one launch of kernel module ``mod``; return its result
    and raise unless the route whose launch count moved is ``named`` (what
    ``mod.route`` names for the shape)."""
    before = dict(mod.ROUTE_LAUNCHES)
    result = fn()
    moved = [r for r, c in mod.ROUTE_LAUNCHES.items() if c != before[r]]
    if moved != [named]:
        raise AssertionError(f"{mod.__name__}: launched {moved}, route() "
                             f"names {named}")
    return result


def generic_route_ms(torch, K2, q, k, v, window) -> float:
    """The generic route's time on inputs a fast route takes (CUDA events,
    the library's launcher called directly, so no launch is counted): the
    route head dim 256 took before it moved onto the fast routes."""
    out = torch.empty_like(q)
    lib = K2._load()
    b, s, hq, d = q.shape

    def run():
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            b, s, hq, k.shape[2], d, window or 0, 1.0 / math.sqrt(d),
            K2._DTYPES[q.dtype], K2.ROUTES.index("generic"),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"generic route launch failed: {err}")

    return cuda_ms(run, reps=10)


def k2_case(torch, K2, dev, gen, shape) -> dict:
    """One K2 shape: the kernel against its plain version, its time (CUDA
    events), SDPA's and the bound (at head dim 256 also the generic
    route's time); raises unless the launch took the route ``K2.route``
    names; logs one line and returns the numbers."""
    F = torch.nn.functional
    b, s, hq, hkv, d, window, dname, tol = shape
    dtype = getattr(torch, dname)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev
                           ).to(dtype) for h in (hq, hkv, hkv))
    path = K2.route(d, dtype)
    got = launched_route(
        K2, lambda: K2.flash_attention(q, k, v, window=window), path)
    out = {}

    def plain():
        out["want"] = K2.flash_attention_plain(q, k, v, window=window)

    plain_ms = cuda_ms(plain, reps=1, warmup=False)
    err, ratio = close(f"K2 {(b, s, hq, hkv, d, window, dname)}", got,
                       out["want"], tol)
    ms = cuda_ms(lambda: K2.flash_attention(q, k, v, window=window),
                 reps=10)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window is None:
        def sdpa():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
    else:
        pos = torch.arange(s, device=dev)
        mask = (pos[:, None] >= pos[None, :]) & \
            (pos[:, None] - pos[None, :] < window)

        def sdpa():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                           enable_gqa=True)
    lib_ms = cuda_ms(sdpa, reps=10)
    esize = q.element_size()
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * esize
    flops = 4 * d * live_pairs(s, window) * hq * b
    bound, by = roofline(nbytes, flops, dtype)
    f32_bound = flops / F32_FLOP_PER_S * 1e3
    bf16_bound = flops / BF16_FLOP_PER_S * 1e3
    rec = {"shape": f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} window={window} "
                    f"{dname}", "route": path, "max_abs_err": err,
           "err_over_allowance": ratio, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
           "f32_fma_bound_ms": f32_bound}
    generic = ""
    if d == 256 and path != "generic":
        rec["generic_ms"] = generic_route_ms(torch, K2, q, k, v, window)
        generic = (f" generic_route_ms={rec['generic_ms']:.4f} "
                   f"kernel_over_generic={ms / rec['generic_ms']:.4f}")
    log(f"K2 b={b} s={s} hq={hq} hkv={hkv} d={d} window={window} "
        f"{dname} route={path}: max_abs_err={err:.3g} "
        f"err_over_allowance={ratio:.3g} (tol {tol}) kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
        f"bound_ms={bound:.5f} ({by}) f32_fma_bound_ms={f32_bound:.5f} "
        f"gflop={flops / 1e9:.3f} tflop_per_s={flops / ms / 1e9:.2f} "
        f"share_of_bf16_bound={bf16_bound / ms:.4f} "
        f"kernel_over_sdpa={ms / lib_ms:.3f}{generic}")
    return rec


def phase_k2(torch, K2, dev) -> dict:
    log("== phase 8: K2 (flash attention) vs plain")
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = [k2_case(torch, K2, dev, gen, shape) for shape in ATTN_SHAPES]
    # the last shape is the main path's: its numbers go into the record
    main = cases[-1]
    pali = next(c for c in cases if c["shape"].endswith("D=256 window=None "
                                                          "bfloat16"))
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:132 "
                        "(pallas_call of _flash_kernel in "
                        "flash_attention_pallas)",
            "launches": 0,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "f32_fma_bound_ms")},
            "shape": "B=1 S=2000 Hq=32 Hkv=4 D=128 bf16",
            "paligemma_3b": {key: pali[key] for key in (
                "shape", "route", "ms", "library_ms", "bound_ms",
                "generic_ms")}}


# b, s, hq, hkv, d, window, dtype name: K2's backward at yi-6b's training
# shape (the main path's: 4 x 2048 tokens, 32/4 heads of 128; first), at
# stablelm-12b's head dim 160 (32/8), musicgen-large's 64 (32/32 heads),
# gemma3-27b's local window of 1024 (32/16 heads of 128), paligemma-3b's
# head dim 256 (8/1) and reduced yi-6b's float32 generic route (4/2 heads
# of 16), each over 2048 positions
ATTN_BWD_SHAPES = [
    (4, 2048, 32, 4, 128, None, "bfloat16"),
    (1, 2048, 32, 8, 160, None, "bfloat16"),
    (1, 2048, 32, 32, 64, None, "bfloat16"),
    (1, 2048, 32, 16, 128, 1024, "bfloat16"),
    (1, 2048, 8, 1, 256, None, "bfloat16"),
    (4, 2048, 4, 2, 16, None, "float32"),
]
# relative L2 of each gradient against the plain backward: float32 sums
# in another order; bfloat16 rounds P and dS to bf16 for their products
# (the plain version keeps them float32) and the gradients to bf16
K2_BWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# the forward's output against the plain forward's (atol = rtol, as phase 8)
# and its log-sum-exp (atol 2e-4, rtol 2e-5: float32 sums in another order)
K2_FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
K2_LSE_ATOL, K2_LSE_RTOL = 2e-4, 2e-5
# relative L2 of K2's gradients through autograd against autograd of the
# plain attention_any on float32 copies of the same inputs
K2_LAYER_TOL = 1e-2


def attention_inputs(torch, gen, dev, b, s, hq, hkv, d, dtype):
    """q, k, v and an output cotangent, normal, in ``dtype``."""
    return [torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
            for h in (hq, hkv, hkv, hq)]


def sdpa_backward_ms(torch, q, k, v, do, window) -> float:
    """The backward of one ``scaled_dot_product_attention`` call
    (``enable_gqa``; the window as a boolean mask) under autograd: CUDA
    events around ``torch.autograd.grad`` of a kept graph."""
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    s = q.shape[1]
    if window is None:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    else:
        pos = torch.arange(s, device=q.device)
        mask = (pos[:, None] >= pos[None, :]) & \
            (pos[:, None] - pos[None, :] < window)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                             retain_graph=True), reps=5)
    del out
    return ms


def check_lse(name: str, got, want) -> float:
    """Max abs error of a log-sum-exp; raise unless finite and within
    ``K2_LSE_ATOL + K2_LSE_RTOL * |want|``."""
    import torch
    diff = (got - want).abs()
    ok = bool((diff <= K2_LSE_ATOL + K2_LSE_RTOL * want.abs()).all())
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: log-sum-exp outside atol "
                             f"{K2_LSE_ATOL} rtol {K2_LSE_RTOL} (max abs "
                             f"err {float(diff.max()):.3g})")
    return float(diff.max())


def k2_bwd_case(torch, K2, dev, gen, shape) -> dict:
    """One shape of K2's backward, from the forward kernel's output and
    log-sum-exp, both first held against the plain forward's: the kernel
    against its plain version (relative L2 per gradient), bitwise across
    two calls, the route ``backward_route`` names, its time and the plain
    version's (CUDA events), SDPA's backward, the bound, the device time
    of each of its CUDA kernels; logs three lines and returns the
    numbers."""
    b, s, hq, hkv, d, window, dname = shape
    dtype = getattr(torch, dname)
    tol = K2_BWD_TOL[dname]
    q, k, v, do = attention_inputs(torch, gen, dev, b, s, hq, hkv, d, dtype)
    o, lse = K2.flash_attention(q, k, v, window=window, return_lse=True)
    o_want, lse_want = K2.flash_attention_plain(q, k, v, window=window,
                                                return_lse=True)
    name = f"K2 forward {shape}"
    o_err, _ = close(name + " o", o, o_want, K2_FWD_TOL[dname])
    lse_err = check_lse(name, lse, lse_want)
    del o_want, lse_want
    free(torch)
    log(f"K2 forward with L b={b} s={s} hq={hq} hkv={hkv} d={d} "
        f"window={window} {dname} route={K2.route(d, dtype)}: o "
        f"max_abs_err={o_err:.3g} (tol {K2_FWD_TOL[dname]}) lse "
        f"max_abs_err={lse_err:.3g} (atol {K2_LSE_ATOL} rtol {K2_LSE_RTOL})")
    args = (q, k, v, o, lse, do)
    path = K2.backward_route(d, dtype)
    before = dict(K2.BWD_ROUTE_LAUNCHES)
    got = K2.flash_attention_backward(*args, window=window)
    moved = [r for r, c in K2.BWD_ROUTE_LAUNCHES.items() if c != before[r]]
    if moved != [path]:
        raise AssertionError(f"K2 backward: launched {moved}, "
                             f"backward_route() names {path}")
    again = K2.flash_attention_backward(*args, window=window)
    bitwise = all(bool(torch.equal(x, y)) for x, y in zip(got, again))
    del again
    out = {}

    def plain():
        out["want"] = K2.flash_attention_backward_plain(*args, window=window)

    plain_ms = cuda_ms(plain, reps=1, warmup=False)
    errs = {}
    for name, x, w in zip(("dq", "dk", "dv"), got, out.pop("want")):
        rel = float((x.float() - w.float()).norm() / w.float().norm())
        errs[name] = (rel, float((x.float() - w.float()).abs().max()))
        if not (rel <= tol and bool(torch.isfinite(x).all())):
            raise AssertionError(f"K2 backward {shape} {name}: rel L2 "
                                 f"{rel:.3g} past {tol}")
    if not bitwise:
        raise AssertionError(f"K2 backward {shape}: two calls differ")
    del got
    free(torch)

    def kernel():
        K2.flash_attention_backward(*args, window=window)

    ms = cuda_ms(kernel, reps=5)
    lib_ms = sdpa_backward_ms(torch, q, k, v, do, window)
    esize = q.element_size()
    # read q, k, v, o, dO and L once; write dq, dk, dv once
    nbytes = (4 * hq + 4 * hkv) * b * s * d * esize + b * hq * s * 4
    flops = 10 * d * live_pairs(s, window) * hq * b
    bound, by = roofline(nbytes, flops, dtype)
    split = kernel_split(torch, kernel, "flash_bwd_")
    err = max(e[1] for e in errs.values())
    log(f"K2 backward b={b} s={s} hq={hq} hkv={hkv} d={d} window={window} "
        f"{dname} route={path}: rel_l2=" + ",".join(
            f"{n}:{e[0]:.3g}" for n, e in errs.items())
        + f" (tol {tol}) max_abs_err={err:.3g} bitwise_two_calls={bitwise} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"sdpa_backward_ms={lib_ms:.4f} bound_ms={bound:.5f} ({by}) "
        f"share_of_bound={bound / ms:.4f} gflop={flops / 1e9:.3f} "
        f"tflop_per_s={flops / ms / 1e9:.2f} kernel_over_sdpa="
        f"{ms / lib_ms:.3f} scratch_bytes={b * hq * s * 4}")
    log(f"K2 backward split b={b} s={s} hq={hq} hkv={hkv} d={d} "
        f"window={window} {dname} (device ms of one call by CUDA kernel, "
        f"torch.profiler): " + ("not measured" if split is None else " ".join(
            f"{n}={v[1]:.4f}({v[0]})" for n, v in split.items())))
    return {"shape": f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} window={window} "
                     f"{dname}", "route": path, "max_abs_err": err,
            "rel_l2": {n: e[0] for n, e in errs.items()}, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": by, "bitwise_two_calls": bitwise,
            "o_max_abs_err": o_err, "lse_max_abs_err": lse_err,
            "split_ms": None if split is None else {
                n: v[1] for n, v in split.items()}}


def attention_layer_ms(torch, dev, shape) -> dict:
    """One yi-6b layer's attention at its training shape, forward and
    backward, through K2 (``ops.flash_attention`` under autograd: the
    forward kernel with its log-sum-exp, then the backward kernel) and
    through autograd of the plain ``attention_any`` (the dense path at S =
    2048, what the train step ran before K2 had a backward), on the same
    inputs (CUDA events).  K2's output and gradients are then held against
    autograd of ``attention_any`` on float32 copies of those inputs (rel L2
    within ``K2_LAYER_TOL``): a check that starts from the inputs, not
    from the kernel's own output and log-sum-exp."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import attention_any
    b, s, hq, hkv, d, window, dname = shape
    gen = torch.Generator(device=dev).manual_seed(81)
    *ins, do = attention_inputs(torch, gen, dev, b, s, hq, hkv, d,
                                getattr(torch, dname))
    out, kept = {}, {}
    for label, fn in (("k2", ops.flash_attention), ("plain", attention_any)):
        live = [t.detach().requires_grad_() for t in ins]

        def fwd():
            out["y"] = fn(*live, window=window)

        def bwd():
            out.pop("grads", None)  # the peak holds one set of gradients
            out["grads"] = torch.autograd.grad(out["y"], live, do,
                                               retain_graph=True)

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd_ms = cuda_ms(fwd, reps=3)
        bwd_ms = cuda_ms(bwd, reps=3)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        out[label] = (fwd_ms, bwd_ms, peak)
        kept[label] = (out.pop("y").detach(), *out.pop("grads"))
        del live
        free(torch)
    ref = [t.detach().float().requires_grad_() for t in ins]
    y = attention_any(*ref, window=window)
    want = (y.detach(), *torch.autograd.grad(y, ref, do.float()))
    del y, ref
    names = ("o", "dq", "dk", "dv")
    errs = {lab: {n: rel_l2(torch, g, w)
                  for n, g, w in zip(names, kept[lab], want)}
            for lab in kept}
    del kept, want
    free(torch)
    log(f"one yi-6b layer's attention at B={b} S={s} {hq}/{hkv} heads of "
        f"{d} {dname}, forward and backward: K2 forward_ms="
        f"{out['k2'][0]:.4f} backward_ms={out['k2'][1]:.4f} "
        f"peak_gib_above_inputs={out['k2'][2]:.3f}; autograd of the plain "
        f"attention_any forward_ms={out['plain'][0]:.4f} backward_ms="
        f"{out['plain'][1]:.4f} peak_gib_above_inputs={out['plain'][2]:.3f}")
    log("  rel L2 against autograd of attention_any in float32 (tol "
        f"{K2_LAYER_TOL} for K2): " + "; ".join(
            f"{lab} " + ",".join(f"{n}:{e:.3g}" for n, e in errs[lab].items())
            for lab in errs))
    bad = {n: e for n, e in errs["k2"].items() if not e <= K2_LAYER_TOL}
    if bad:
        raise AssertionError(f"K2 through autograd at {shape}: rel L2 {bad} "
                             f"past {K2_LAYER_TOL} of autograd of "
                             f"attention_any in float32")
    return {"k2_forward_ms": out["k2"][0], "k2_backward_ms": out["k2"][1],
            "k2_peak_gib": out["k2"][2], "plain_forward_ms": out["plain"][0],
            "plain_backward_ms": out["plain"][1],
            "plain_peak_gib": out["plain"][2],
            "rel_l2_vs_float32_autograd": errs}


def check_bwd_spills(spills: dict[str, int]) -> None:
    """K2's backward on its tensor-core routes must not spill: on ``wgmma``
    a dK/dV thread holds dK and dV (128 float32 at D = 128) beside S^T or
    dP^T, on ``mma`` the dK/dV block two float32 accumulators of 64 x D/2
    a warp pair."""
    for route in ("wgmma", "mma"):
        got = {f: n for f, n in spills.items() if f"_{route}I" in f}
        log(f"K2 backward {route} spill store bytes: {got}")
        if not got or any(got.values()):
            raise AssertionError(f"K2 backward {route} route: spill stores "
                                 f"{got}")


def phase_k2_backward(torch, K2, dev) -> dict:
    log("== phase 8b: K2 backward vs plain (the gradient's formulas in "
        "eager float32)")
    gen = torch.Generator(device=dev).manual_seed(28)
    cases = [k2_bwd_case(torch, K2, dev, gen, shape)
             for shape in ATTN_BWD_SHAPES]
    main = cases[0]
    return {"name": "flash_attention_backward", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:242 (attention_any "
                        "in gqa_forward, differentiated inside the jitted "
                        "train step src/repro/train/loop.py:108 and fused "
                        "by XLA; the pallas_call of "
                        "src/repro/kernels/flash_attention.py:132 has no "
                        "backward)",
            "launches": 0,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "split_ms", "rel_l2")},
            "shape": main["shape"],
            "cases": cases[1:],
            "attention_layer": attention_layer_ms(torch, dev,
                                                  ATTN_BWD_SHAPES[0])}


def k3_case(torch, K3, dev, gen, shape) -> dict:
    """One K3 shape: the kernel against its plain version (the exact
    recurrence), its time (CUDA events), the bound and its CUDA kernels
    per call; logs one line and returns the numbers."""
    bt, s, h, p, g, n, dname, tol = shape
    dtype = getattr(torch, dname)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(bt, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(bt, s, h))
    A = -torch.exp(randn(h) * 0.5)
    B, C = randn(bt, s, g, n).to(dtype), randn(bt, s, g, n).to(dtype)
    path = K3.route(n, p, dtype)
    y, state = launched_route(K3, lambda: K3.ssd_scan(x, dt, A, B, C), path)
    out = {}

    def plain():
        out["want"] = K3.ssd_scan_plain(x, dt, A, B, C)

    plain_ms = cuda_ms(plain, reps=1, warmup=False)
    name = f"K3 {(bt, s, h, p, g, n, dname)}"
    (e_y, r_y), (e_s, r_s) = (close(name + " y", y, out["want"][0], tol),
                              close(name + " state", state,
                                    out["want"][1], tol))
    err, ratio = max(e_y, e_s), max(r_y, r_s)
    ms = cuda_ms(lambda: K3.ssd_scan(x, dt, A, B, C), reps=10)
    esize = x.element_size()
    nbytes = (2 * bt * s * h * p + 2 * bt * s * g * n) * esize + \
        (bt * s * h + h + bt * h * n * p) * 4
    # the recurrence's work: state * decay + B (dt x) and C . state
    flops = 5 * n * p * s * h * bt
    bound, by = roofline(nbytes, flops, dtype)
    scratch = K3.scratch_bytes(bt, s, h, n, p, dtype)
    per_call, _ = device_kernels(torch, lambda: K3.ssd_scan(x, dt, A, B, C),
                                 "ssd_")
    blocks = bt * K3.n_chunks(s, dtype) * h if path == "chunked" else bt * h
    log(f"K3 bt={bt} s={s} h={h} p={p} g={g} n={n} {dname} route={path}: "
        f"max_abs_err={err:.3g} err_over_allowance={ratio:.3g} "
        f"(tol {tol}) kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms=null bound_ms={bound:.5f} "
        f"({by}) share_of_bytes_bound="
        f"{nbytes / HBM_BYTES_PER_S * 1e3 / ms:.4f} "
        f"cuda_kernels_per_call="
        f"{'not measured' if per_call is None else per_call} "
        f"blocks={blocks} scratch_bytes={scratch}")
    return {"shape": f"Bt={bt} S={s} H={h} P={p} G={g} N={n} {dname}",
            "route": path, "max_abs_err": err, "err_over_allowance": ratio,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound, "bound_by": by,
            "cuda_kernels_per_call": per_call}


def phase_k3(torch, K3, dev) -> dict:
    log("== phase 9: K3 (SSD scan) vs plain (exact recurrence)")
    gen = torch.Generator(device=dev).manual_seed(9)
    cases = [k3_case(torch, K3, dev, gen, shape) for shape in SSD_SHAPES]
    main = cases[-1]
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:98 (pallas_call of "
                        "_ssd_kernel in ssd_scan_pallas)",
            "launches": 0,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "cuda_kernels_per_call")},
            "shape": "Bt=1 S=2048 H=64 P=64 G=1 N=128 bf16"}


# bt, s, h, p, g, n, dtype name: K3's backward on the chunked route (N = P
# = 128 in float32, two groups in bf16; 12 heads, not a multiple of the
# gradient pass's slab of 8, over S shorter than one chunk; float32 at N =
# P = 128 with 10 heads a group, whose 32-position chunks are halves of
# the forward's), on the generic route (phase 16's reduced shape, and
# phase 18a's float32 training batch of reduced mamba2-1.3b), then
# mamba2-1.3b's training shape (4 x 2048 tokens, the main path's, last)
SSD_BWD_SHAPES = [
    (1, 256, 2, 128, 1, 128, "float32"),
    (2, 300, 4, 64, 2, 128, "bfloat16"),
    (2, 40, 12, 64, 1, 64, "bfloat16"),
    (1, 300, 20, 128, 2, 128, "float32"),
    (1, 2048, 8, 16, 1, 16, "bfloat16"),
    (4, 128, 8, 16, 1, 16, "float32"),
    (4, 2048, 64, 64, 1, 128, "bfloat16"),
]
# relative L2 of each gradient against the plain backward: float32 sums in
# other orders (the generic route runs the exact recurrence); bf16 adds
# the rounding of dx, dB, dC to bf16 on both sides.  The bf16 limit lies
# between the kernel (<= 1.3e-4) and a build whose float32 factors lose
# their lo terms (dx, dB, dC 2.5e-3-2.8e-3; scripts/k3_bwd_lo_control.py)
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-4}


def ssd_bwd_work(bt, s, h, p, g, n, esize) -> tuple[int, int]:
    """(bytes, operations) of one backward call.  Bytes: x, dy, dx, B, C,
    dB, dC in the inputs' type, dt, ddt, A, dA and the final state's
    cotangent in float32, each read or written once.  Operations: 14 N P
    per token and head, the exact reverse recurrence's: the state again
    (3: its decay, the B x product and the sum; the forward's output
    product C state is not needed, dy is given), the state's cotangent
    (3), dx, dB, dC and the decay's gradient (2 each)."""
    nbytes = (3 * bt * s * h * p + 4 * bt * s * g * n) * esize + \
        (2 * bt * s * h + 2 * h + bt * h * n * p) * 4
    return nbytes, 14 * n * p * s * h * bt


def ssd_inputs(torch, gen, dev, bt, s, h, p, g, n, dtype):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = randn(bt, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(bt, s, h))
    A = -torch.exp(randn(h) * 0.5)
    B, C = randn(bt, s, g, n).to(dtype), randn(bt, s, g, n).to(dtype)
    return x, dt, A, B, C


def k3_bwd_case(torch, K3, dev, gen, shape) -> dict:
    """One shape of K3's backward, given the incoming chunk states K3's
    forward keeps (chunked route): the kernel against its plain version
    (which recomputes the states; relative L2 per gradient), bitwise
    across two calls, its time and the plain version's (CUDA events), the
    bound, the device time of each CUDA kernel of a call, scratch bytes
    and the forward's saved bytes; logs two lines and returns the
    numbers."""
    bt, s, h, p, g, n, dname = shape
    dtype = getattr(torch, dname)
    tol = SSD_BWD_TOL[dname]
    x, dt, A, B, C = ssd_inputs(torch, gen, dev, bt, s, h, p, g, n, dtype)
    dy = torch.randn((bt, s, h, p), generator=gen, device=dev).to(dtype)
    dfinal = torch.randn((bt, h, n, p), generator=gen, device=dev)
    _, _, states = K3.ssd_scan(x, dt, A, B, C, keep_states=True)
    saved = 0 if states is None else states.numel() * 4
    args = (x, dt, A, B, C, dy, dfinal, states)
    path = K3.backward_route(n, p, dtype)
    before = dict(K3.BWD_ROUTE_LAUNCHES)
    got = K3.ssd_scan_backward(*args)
    moved = [r for r, c in K3.BWD_ROUTE_LAUNCHES.items() if c != before[r]]
    if moved != [path]:
        raise AssertionError(f"K3 backward: launched {moved}, "
                             f"backward_route() names {path}")
    again = K3.ssd_scan_backward(*args)
    out = {}

    def plain():
        out["want"] = K3.ssd_scan_backward_plain(*args[:7])

    plain_ms = cuda_ms(plain, reps=1, warmup=False)
    errs = {}
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                          out["want"]):
        rel = float((a.float() - w.float()).norm() / w.float().norm())
        errs[name] = (rel, float((a.float() - w.float()).abs().max()))
        if not (rel <= tol and bool(torch.isfinite(a).all())):
            raise AssertionError(f"K3 backward {shape} {name}: rel L2 "
                                 f"{rel:.3g} past {tol}")
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    if not bitwise:
        raise AssertionError(f"K3 backward {shape}: two calls differ")
    ms = cuda_ms(lambda: K3.ssd_scan_backward(*args), reps=5)
    nbytes, flops = ssd_bwd_work(bt, s, h, p, g, n, x.element_size())
    bound, by = roofline(nbytes, flops, dtype)
    split = kernel_split(torch, lambda: K3.ssd_scan_backward(*args),
                         "::bwd_")
    per_call = None if split is None else sum(c for c, _ in split.values())
    err = max(e[1] for e in errs.values())
    log(f"K3 backward bt={bt} s={s} h={h} p={p} g={g} n={n} {dname} "
        f"route={path}: rel_l2=" + ",".join(
            f"{k}:{v[0]:.3g}" for k, v in errs.items())
        + f" (tol {tol}) max_abs_err={err:.3g} bitwise_two_calls={bitwise}"
        f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=null "
        f"bound_ms={bound:.5f} ({by}) share_of_bound={bound / ms:.4f} "
        f"cuda_kernels_per_call="
        f"{'not measured' if per_call is None else per_call} "
        f"scratch_bytes="
        f"{K3.backward_scratch_bytes(bt, s, h, n, p, dtype, g)} "
        f"forward_states_bytes={saved}")
    log(f"K3 backward split bt={bt} s={s} h={h} p={p} g={g} n={n} {dname}"
        f" (device ms of one call by CUDA kernel, torch.profiler): " + (
            "not measured" if split is None else " ".join(
                f"{k}={v[1]:.4f}({v[0]})" for k, v in split.items())))
    return {"shape": f"Bt={bt} S={s} H={h} P={p} G={g} N={n} {dname}",
            "route": path, "max_abs_err": err,
            "rel_l2": {k: v[0] for k, v in errs.items()}, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
            "bound_by": by, "cuda_kernels_per_call": per_call,
            "scratch_bytes": K3.backward_scratch_bytes(bt, s, h, n, p, dtype,
                                                       g),
            "forward_states_bytes": saved,
            "split_ms": None if split is None else {
                k: v[1] for k, v in split.items()}}


def ssd_autograd_ms(torch, K3, dev, shape) -> dict:
    """One Mamba layer's SSD at ``shape`` forward and backward, by K3
    (``ops.ssd_scan`` under autograd: the forward kernel, then the
    backward kernel) and by autograd of the plain ``ssd_chunked`` (chunk
    256, the model's), on the same inputs (CUDA events)."""
    from repro_torch.kernels import ops
    from repro_torch.models.mamba import ssd_chunked
    bt, s, h, p, g, n, dname = shape
    dtype = getattr(torch, dname)
    gen = torch.Generator(device=dev).manual_seed(91)
    ins = ssd_inputs(torch, gen, dev, bt, s, h, p, g, n, dtype)
    dy = torch.randn((bt, s, h, p), generator=gen, device=dev).to(dtype)
    out = {}
    for label, fn in (("k3", lambda *t: ops.ssd_scan(*t)),
                      ("plain", lambda *t: ssd_chunked(*t, 256))):
        live = [t.detach().requires_grad_() for t in ins]

        def fwd():
            out["y"] = fn(*live)[0]

        def bwd():
            torch.autograd.grad(out["y"], live, dy, retain_graph=True)

        fwd_ms = cuda_ms(fwd, reps=3)
        bwd_ms = cuda_ms(bwd, reps=3)
        out[label] = (fwd_ms, bwd_ms)
        out.pop("y")
    log(f"one Mamba layer's SSD at Bt={bt} S={s} H={h} P={p} N={n} {dname}"
        f", forward and backward: K3 forward_ms={out['k3'][0]:.4f} "
        f"backward_ms={out['k3'][1]:.4f}; autograd of the plain ssd_chunked"
        f" forward_ms={out['plain'][0]:.4f} backward_ms="
        f"{out['plain'][1]:.4f}")
    return {"k3_forward_ms": out["k3"][0], "k3_backward_ms": out["k3"][1],
            "plain_forward_ms": out["plain"][0],
            "plain_backward_ms": out["plain"][1]}


def phase_k3_backward(torch, K3, dev) -> dict:
    log("== phase 9b: K3 backward vs plain (the same chunked decomposition "
        "in eager float32)")
    gen = torch.Generator(device=dev).manual_seed(19)
    cases = [k3_bwd_case(torch, K3, dev, gen, shape)
             for shape in SSD_BWD_SHAPES]
    main = cases[-1]
    return {"name": "ssd_scan_backward", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:98 (the pallas_call "
                        "of _ssd_kernel has no backward in repro: its train "
                        "step differentiates src/repro/models/mamba.py:85 "
                        "ssd_chunked, fused by XLA)",
            "launches": 0,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "cuda_kernels_per_call",
                                          "split_ms", "scratch_bytes",
                                          "forward_states_bytes")},
            "shape": "Bt=4 S=2048 H=64 P=64 G=1 N=128 bf16",
            "generic": [c for c in cases if c["route"] == "generic"]}


# ---------------------------------------------------------------------------
# phase 9c: the AdamW update (K5)
# ---------------------------------------------------------------------------

# the card tests' tensor set: ragged against 8-element vectors and the
# kernel's 32768-element chunks; decay on every other tensor
K5_SIZES = (1, 7, 8, 33, 1000, 32768, 32769, 100003)
K5_HYPER = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                grad_clip=1.0)


def k5_ulps(torch, a, b) -> int:
    it = torch.int32 if a.dtype == torch.float32 else torch.int16
    return int((a.view(it).long() - b.view(it).long()).abs().max())


def k5_test_case(torch, K5, dev, combo, grad_scale, offset) -> dict:
    """One tensor set of ``combo`` (parameter, gradient, moment dtypes):
    the kernel and the plain version in place from the same state; the
    norm's relative error, the moments' relative L2 and the parameters'
    largest distance in ulps, and whether everything is bit for bit."""
    p_dt, g_dt, m_dt = combo
    gen = torch.Generator(device=dev).manual_seed(23)

    def draw(n, dtype, off, scale=1.0, absolute=False):
        a = torch.randn(n + off, generator=gen, device=dev) * scale
        return (a.abs() if absolute else a).to(dtype)[off:]

    sets = ([], [], [], [])
    for i, n in enumerate(K5_SIZES):
        offs = [(i + k) % 3 if offset else 0 for k in range(4)]
        sets[0].append(draw(n, g_dt, offs[0], grad_scale))
        sets[1].append(draw(n, p_dt, offs[1]))
        sets[2].append(draw(n, m_dt, offs[2], 0.1))
        sets[3].append(draw(n, m_dt, offs[3], 0.01, absolute=True))
    decays = [i % 2 == 0 for i in range(len(K5_SIZES))]

    def state():
        out = []
        for ts in sets[1:]:
            copies = []
            for t in ts:
                base = torch.empty(t.storage_offset() + t.numel(),
                                   dtype=t.dtype, device=dev)
                copies.append(base[t.storage_offset():].copy_(t))
            out.append(copies)
        return (*out, torch.tensor(3, dtype=torch.int32, device=dev))

    p0, m0, v0, s0 = state()
    want = K5.adamw_step_plain_(sets[0], p0, m0, v0, s0, decays, **K5_HYPER)
    p1, m1, v1, s1 = state()
    got = K5.adamw_step_(sets[0], p1, m1, v1, s1, decays, **K5_HYPER)
    torch.cuda.synchronize()

    def rel_l2_of(a, b):
        return math.sqrt(sum(float((x.double() - y.double()).norm()) ** 2
                             for x, y in zip(a, b))
                         / sum(float(y.double().norm()) ** 2 for y in b))
    # the plain per-tensor formula fed the kernel's own norm
    pi, mi, vi, si = state()
    scale = K5.clip_scale(got, K5_HYPER["grad_clip"])
    _, c1, c2 = K5.bias_corrections(si, K5_HYPER["b1"], K5_HYPER["b2"])
    hyper = {k: x for k, x in K5_HYPER.items() if k != "grad_clip"}
    own = all(k5_ulps(torch, a, b) == 0
              for i in range(len(K5_SIZES))
              for a, b in zip(K5.update_tensor(
                  sets[0][i], mi[i], vi[i], pi[i], decays[i], scale, c1, c2,
                  **hyper), (p1[i], m1[i], v1[i])))
    return {"norm_rel": abs(float(got) / float(want) - 1),
            "clipped": float(want) > K5_HYPER["grad_clip"],
            "moment_rel_l2": max(rel_l2_of(m1, m0), rel_l2_of(v1, v0)),
            "param_rel_l2": rel_l2_of(p1, p0),
            "param_ulps": max(k5_ulps(torch, a, b) for a, b in zip(p1, p0)),
            "max_abs_err": max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(p1, p0)),
            "bitwise": all(k5_ulps(torch, a, b) == 0 for a, b in
                           zip(p1 + m1 + v1, p0 + m0 + v0))
            and int(s1) == int(s0) == 4,
            "bitwise_given_own_norm": own}


def k5_model_set(torch, cfg, moment_dtype, dev, grad_scale=1e-4):
    """A model's parameter set on the card (``init_params`` from seed 0),
    random gradients in the parameters' dtypes, random moments, the decay
    flags, and ``moments(i)``, which draws tensor ``i``'s moments anew
    (each from a seed of its own), so a check can read the inputs again
    after an in-place call has overwritten them."""
    import torch.utils._pytree as pytree

    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import _decays
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    flat = pytree.tree_flatten_with_path(params)[0]
    ps = [p for _, p in flat]
    decays = [_decays(path, p) for path, p in flat]
    del params, flat
    gen = torch.Generator(device=dev).manual_seed(29)
    gs = [(torch.randn(p.shape, generator=gen, device=dev) * grad_scale)
          .to(p.dtype) for p in ps]

    def moments(i):
        g = torch.Generator(device=dev).manual_seed(1000 + i)
        m = torch.randn(ps[i].shape, generator=g, device=dev) * 1e-3
        v = torch.randn(ps[i].shape, generator=g, device=dev) * 1e-6
        return m.to(moment_dtype), v.abs_().to(moment_dtype)
    ms, vs = zip(*(moments(i) for i in range(len(ps))))
    return gs, ps, list(ms), list(vs), decays, moments


def k5_full_check(torch, K5, label: str, gs, ps, ms, vs, decays, moments,
                  dev) -> dict:
    """K5 in place once at a model's whole parameter set, held to its
    plain version: the norm within 1e-6 of the plain one, every tensor's
    parameters and moments bit for bit against the plain per-tensor
    formula fed the kernel's own norm, and ``step`` advanced once; raises
    on a miss.  Against the plain formula at the plain norm (the clip
    scales an ulp or so apart) it reports, without a limit, each result's
    relative L2, largest distance in ulps and elements that differ: that
    distance is the formula's answer to the norm's rounding, not the
    kernel's arithmetic (at full size a few hundred bf16 parameters sit on
    a rounding edge, and where a step nearly cancels a parameter one ulp
    of the scale is many of the result).  The inputs are read again after
    the call: the parameters from a copy, the moments drawn anew."""
    p_old = [p.clone() for p in ps]
    step = torch.tensor(3, dtype=torch.int32, device=dev)
    want = K5.grad_norm(gs)
    got = K5.adamw_step_(gs, ps, ms, vs, step, decays, **K5_HYPER)
    torch.cuda.synchronize()
    hyper = {k: x for k, x in K5_HYPER.items() if k != "grad_clip"}
    _, c1, c2 = K5.bias_corrections(
        torch.tensor(3, dtype=torch.int32, device=dev), hyper["b1"],
        hyper["b2"])
    scales = [K5.clip_scale(x, K5_HYPER["grad_clip"]) for x in (got, want)]
    own = True
    # per result (parameters, first and second moments): squared distance
    # and norm, largest distance in ulps, elements that differ, dtype
    st = {k: {"sq": 0.0, "norm_sq": 0.0, "ulps": 0, "differ": 0,
              "dtype": None} for k in ("p", "m", "v")}

    def same_bits(a, b):
        it = torch.int32 if a.dtype == torch.float32 else torch.int16
        return torch.equal(a.view(it), b.view(it))
    for i in range(len(ps)):
        m0, v0 = moments(i)
        new = (ps[i], ms[i], vs[i])
        mine = K5.update_tensor(gs[i], m0, v0, p_old[i], decays[i],
                                scales[0], c1, c2, **hyper)
        own = own and all(same_bits(a, b) for a, b in zip(mine, new))
        del mine
        plain = K5.update_tensor(gs[i], m0, v0, p_old[i], decays[i],
                                 scales[1], c1, c2, **hyper)
        for key, a, b in zip(("p", "m", "v"), new, plain):
            s = st[key]
            it = torch.int32 if a.dtype == torch.float32 else torch.int16
            s["differ"] += int((a.view(it) != b.view(it)).sum())
            s["ulps"] = max(s["ulps"], k5_ulps(torch, a, b))
            s["sq"] += float((a.double() - b.double()).norm()) ** 2
            s["norm_sq"] += float(b.double().norm()) ** 2
            s["dtype"] = str(a.dtype).split(".")[-1]
        del plain, m0, v0
    del p_old
    results = {k: {"dtype": s["dtype"], "rel_l2": math.sqrt(
        s["sq"] / s["norm_sq"]), "max_ulps": s["ulps"],
        "elements_differ": s["differ"]} for k, s in st.items()}
    out = {"norm_rel": abs(float(got) / float(want) - 1),
           "clipped": float(want) > K5_HYPER["grad_clip"],
           "bitwise_given_own_norm": own, "vs_plain": results,
           "step": int(step)}
    log(f"K5 at {label}'s parameters, once against the plain version: "
        f"norm_rel={out['norm_rel']:.3g} clipped={out['clipped']} "
        f"bitwise_given_own_norm={own} step={out['step']} vs the plain "
        f"version at its own norm: " + " ".join(
            f"{k}({r['dtype']}): rel_l2={r['rel_l2']:.3g} max_ulps="
            f"{r['max_ulps']} elements_differ={r['elements_differ']}"
            for k, r in results.items()))
    if not (out["norm_rel"] <= 1e-6 and own and out["step"] == 4):
        raise AssertionError(f"K5 at {label}'s parameters: outside its "
                             f"limits {out}")
    return out


def k5_timing(torch, K5, label: str, cfg, moment_dtype, dev) -> dict:
    """K5 in place at a model's parameter set: first once against its
    plain version (:func:`k5_full_check`), then ms (CUDA events, 10
    calls), the device ms of its CUDA kernels (one profiled call), the
    bound, the plain version's ms (in place, 2 calls) and the library's
    (``torch._foreach_norm`` + ``torch._fused_adamw_`` per dtype group, on
    moments in the parameters' dtype where the set's differ: the fused
    kernel takes one dtype; timed only, never on the path)."""
    gs, ps, ms, vs, decays, moments = k5_model_set(torch, cfg, moment_dtype,
                                                   dev)
    check = k5_full_check(torch, K5, label, gs, ps, ms, vs, decays, moments,
                          dev)
    step = torch.tensor(3, dtype=torch.int32, device=dev)
    n = sum(p.numel() for p in ps)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    once = nbytes(gs) + 2 * (nbytes(ps) + nbytes(ms) + nbytes(vs))
    two_pass = once + nbytes(gs)
    # float32 operations: the norm's multiply-add (2), the update's 15, 2
    # more where a tensor decays
    flops = 17 * n + 2 * sum(p.numel() for p, d in zip(ps, decays) if d)
    bound, by = roofline(once, flops, torch.float32)

    def k5():
        return K5.adamw_step_(gs, ps, ms, vs, step, decays, **K5_HYPER)
    gnorm = float(k5())
    ms_k5 = cuda_ms(k5, reps=10)
    split = kernel_split(torch, k5, "adamw_")
    plain_ms = cuda_ms(lambda: K5.adamw_step_plain_(
        gs, ps, ms, vs, step, decays, **K5_HYPER), reps=2)
    lib_m = ms if moment_dtype == ps[0].dtype and all(
        m.dtype == p.dtype for m, p in zip(ms, ps)) else None
    note = "same tensors"
    if lib_m is None:
        lib_m = [m.to(p.dtype) for m, p in zip(ms, ps)]
        lib_v = [v.to(p.dtype) for v, p in zip(vs, ps)]
        note = "moments copied to the parameters' dtype"
    else:
        lib_v = vs
    groups: dict = {}
    for i, p in enumerate(ps):
        groups.setdefault((p.dtype, gs[i].dtype), []).append(i)
    steps_f = {k: torch.tensor(3.0, device=dev) for k in groups}

    def library():
        torch._foreach_norm(gs)
        for k, idx in groups.items():
            torch._fused_adamw_(
                [ps[i] for i in idx], [gs[i] for i in idx],
                [lib_m[i] for i in idx], [lib_v[i] for i in idx], [],
                [steps_f[k]] * len(idx), lr=K5_HYPER["lr"],
                beta1=K5_HYPER["b1"], beta2=K5_HYPER["b2"],
                weight_decay=K5_HYPER["weight_decay"], eps=K5_HYPER["eps"],
                amsgrad=False, maximize=False, grad_scale=None,
                found_inf=None)
    library_ms = cuda_ms(library, reps=10)
    out = {"set": label, "tensors": len(ps), "elements": n,
           "grad_norm": gnorm, "full_check": check, "ms": ms_k5,
           "plain_ms": plain_ms,
           "library_ms": library_ms, "library_note": note,
           "bound_ms": bound, "bound_by": by,
           "two_pass_bound_ms": two_pass / HBM_BYTES_PER_S * 1e3,
           "bytes_once": once, "bytes_two_pass": two_pass,
           "split_ms": None if split is None else {
               k: v[1] for k, v in split.items()},
           "cuda_kernels_per_call": None if split is None else sum(
               c for c, _ in split.values())}
    log(f"K5 at {label}'s parameters ({len(ps)} tensors, {n} elements, "
        f"moments {str(moment_dtype).split('.')[-1]}): kernel_ms="
        f"{ms_k5:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"({note}) bound_ms={bound:.4f} ({by}; {once} bytes once) "
        f"two_pass_bound_ms={out['two_pass_bound_ms']:.4f} share_of_bound="
        f"{bound / ms_k5:.4f} grad_norm={gnorm:.5g} split (device ms by "
        f"CUDA kernel): " + ("not measured" if split is None else " ".join(
            f"{k}={v[1]:.4f}({v[0]})" for k, v in split.items())))
    del gs, ps, ms, vs, lib_m, lib_v
    free(torch)
    return out


def phase_k5(torch, K5, dev) -> dict:
    """9c: K5 against its plain version on the card tests' tensor sets
    (every dtype combination, aligned and at element offsets, under the
    clip bit for bit, with clipping within limits), then at mamba2-1.3b's
    and yi-6b's whole parameter sets: once against the plain version,
    then its times."""
    from repro_torch.configs import get_config
    log("== phase 9c: K5 (AdamW) vs plain, then at mamba2-1.3b's and "
        "yi-6b's parameter sets")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for combo in [(p, g, m) for p in (f32, bf16) for g in (f32, bf16)
                  for m in (f32, bf16)]:
        name = "-".join("bf16" if d == bf16 else "f32" for d in combo)
        for grad_scale, offset in ((1e-3, False), (1e-3, True),
                                   (1e-1, True)):
            c = k5_test_case(torch, K5, dev, combo, grad_scale, offset)
            c["case"] = f"{name} {'clipped' if c['clipped'] else 'unclipped'}" \
                f"{' offset' if offset else ''}"
            log(f"K5 {c['case']}: bitwise={c['bitwise']} "
                f"bitwise_given_own_norm={c['bitwise_given_own_norm']} "
                f"norm_rel={c['norm_rel']:.3g} moment_rel_l2="
                f"{c['moment_rel_l2']:.3g} param_rel_l2="
                f"{c['param_rel_l2']:.3g} param_ulps={c['param_ulps']} "
                f"max_abs_err={c['max_abs_err']:.3g}")
            ok = c["norm_rel"] <= 1e-6 and c["bitwise_given_own_norm"] and (
                c["bitwise"] if not c["clipped"] else
                c["moment_rel_l2"] <= 1e-6 and c["param_rel_l2"] <= 1e-6)
            if not ok or c["clipped"] != (grad_scale > 1e-2):
                raise AssertionError(f"K5 {c['case']}: outside its limits")
            cases.append(c)
    sets = {"mamba2-1.3b": k5_timing(torch, K5, "mamba2-1.3b",
                                     get_config("mamba2-1.3b"), f32, dev),
            "yi-6b": k5_timing(torch, K5, "yi-6b", get_config("yi-6b"),
                               bf16, dev)}
    main = sets["mamba2-1.3b"]
    return {"name": "adamw", "route": "cuda",
            "source": "src/repro_torch/csrc/adamw.cu",
            "replaces": "src/repro/train/optimizer.py:44 (adamw_update, "
                        "fused into the jax.jit of src/repro/train/loop.py:"
                        "108 with donate_argnums=(0, 1))",
            "launches": 0,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "two_pass_bound_ms",
                                    "split_ms", "cuda_kernels_per_call",
                                    "full_check")},
            "shape": "mamba2-1.3b's parameters: 818 tensors, bf16 "
                     "parameters and gradients, float32 moments",
            "yi_6b": sets["yi-6b"],
            "cases": [{k: c[k] for k in (
                "case", "bitwise", "bitwise_given_own_norm", "norm_rel",
                "moment_rel_l2", "param_rel_l2", "param_ulps")}
                for c in cases]}


# ---------------------------------------------------------------------------
# phase 9e: the Mamba block's kernels (K6 conv, K7 gated norm, K8 decode)
# ---------------------------------------------------------------------------

# name, Bt, S, d_inner, heads, N, groups, dtype, what runs ("train": K6 and
# K7 forward and backward; "prefill": K6 keeping its new states, K7
# forward; "decode": K6 from a state (its own route, which the decode no
# longer takes), K8 from the same projections and states, K7 without the
# skip).  d_conv is
# 4 in every config.  mamba2-1.3b's shapes are the main path's: 4 x 2048
# training tokens, a 2000-token prompt, one token; jamba-1.5-large-398b's
# layer widths (d_inner 16384, 128 heads of 128); mamba2-1.3b-reduced's
# (d_inner 128, 8 heads of 16, N 16) in both types.
MAMBA_CASES = (
    ("mamba2-1.3b train", 4, 2048, 4096, 64, 128, 1, "bfloat16", "train"),
    ("mamba2-1.3b prefill", 1, 2000, 4096, 64, 128, 1, "bfloat16",
     "prefill"),
    ("mamba2-1.3b decode", 1, 1, 4096, 64, 128, 1, "bfloat16", "decode"),
    ("jamba layer train", 1, 2048, 16384, 128, 128, 1, "bfloat16", "train"),
    ("jamba layer decode", 1, 1, 16384, 128, 128, 1, "bfloat16", "decode"),
    ("reduced train", 2, 64, 128, 8, 16, 1, "float32", "train"),
    ("reduced train", 2, 64, 128, 8, 16, 1, "bfloat16", "train"),
    ("reduced decode", 2, 1, 128, 8, 16, 1, "float32", "decode"),
    ("reduced decode", 2, 1, 128, 8, 16, 1, "bfloat16", "decode"),
)
CONV_K = 4
# relative L2 limits against the plain versions where sums run in other
# orders: float32 outputs; bf16 outputs (one bf16 ulp is 2^-8 relative);
# forwards whose every op is the plain version's (K6's outputs and new
# states, K8's state) must be within one ulp of it, element by element
MAMBA_REL = {"float32": 1e-5, "bfloat16": 4e-3}
MAMBA_MAX_ULPS = 1
# the previous K6 and K7 (a thread a channel; a block a row, two passes)
# and K8 (the state step alone, after K6's decode: a block per row, head
# and 32 columns, scalar loads) at the same shapes: device ms of one call,
# this phase on an NVIDIA H100 80GB HBM3 at 700 W, printed beside this run's
MAMBA_BEFORE_MS = {
    ("mamba2-1.3b decode", "K8"): 0.0057,
    ("jamba layer decode", "K8"): 0.0064,
    ("mamba2-1.3b train", "K6"): 0.1441,
    ("mamba2-1.3b train", "K6_backward"): 0.2430,
    ("mamba2-1.3b train", "K7"): 0.2353,
    ("mamba2-1.3b train", "K7_backward"): 0.5492,
    ("mamba2-1.3b prefill", "K6"): 0.0434,
    ("mamba2-1.3b prefill", "K7"): 0.0659,
    ("mamba2-1.3b decode", "K6"): 0.0030,
    ("mamba2-1.3b decode", "K7"): 0.0046,
    ("jamba layer train", "K6"): 0.1393,
    ("jamba layer train", "K6_backward"): 0.2340,
    ("jamba layer train", "K7"): 0.3019,
    ("jamba layer train", "K7_backward"): 1.4860,
}


def ordered_bits(torch, t):
    """``t``'s floats as integers in the floats' order (bf16 or float32)."""
    if t.dtype == torch.bfloat16:
        i = t.view(torch.int16).to(torch.int64)
        return torch.where(i < 0, -(i + (1 << 15)), i)
    i = t.float().contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i + (1 << 31)), i)


def ulps(torch, got, want) -> int:
    """The largest distance in ulps between two tensors of one type."""
    if got.numel() == 0:
        return 0
    return int((ordered_bits(torch, got) - ordered_bits(torch, want))
               .abs().max())


def held(torch, label: str, got, want, dtype: str,
         max_ulps: int | None = None) -> dict:
    """Kernel vs plain outputs (lists): relative L2, largest abs error,
    largest ulps and bitwise share; raises outside the limits (``max_ulps``
    where every op is the plain version's, else ``MAMBA_REL``)."""
    rel = rel_l2(torch, got, want)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in
              zip(got, want))
    u = max(ulps(torch, g, w) for g, w in zip(got, want))
    same = sum(int((g == w).sum()) for g, w in zip(got, want))
    total = sum(w.numel() for w in want)
    out = {"rel_l2": rel, "max_abs_err": err, "ulps": u,
           "bitwise_share": same / total}
    ok = u <= max_ulps if max_ulps is not None else \
        rel <= MAMBA_REL[dtype] or same == total
    log(f"  {label}: rel_l2={rel:.3g} max_abs_err={err:.3g} ulps_max={u} "
        f"bitwise_share={same / total:.6f}"
        + ("" if ok else "  <-- outside the limit"))
    if not ok:
        raise AssertionError(f"{label}: outside its limit")
    return out


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device ms of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the replay timed with CUDA events (after one eager call and one
    replay), so a small kernel's time is not its host launch's."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = cuda_ms(graph.replay, 3, warmup=False) / reps
    del graph
    return ms


def graph_split(torch, fn, key: str,
                reps: int = 20) -> dict[str, tuple[float, float]] | None:
    """By CUDA kernel whose name holds ``key``: launches and device ms of
    one call of ``fn``, from ``torch.profiler`` over one replay of ``reps``
    calls captured in a CUDA graph (:func:`kernel_split`), divided by
    ``reps``; ``None`` where the trace stayed empty (not measured)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    split = kernel_split(torch, graph.replay, key)
    del graph
    if split is None:
        return None
    return {k: (c / reps, ms / reps) for k, (c, ms) in split.items()}


def split_text(split) -> str:
    """``name=ms(launches)`` of a :func:`graph_split`, or not measured."""
    if split is None:
        return "not measured"
    return " ".join(f"{k}={ms:.4f}({c:g})" for k, (c, ms) in split.items())


def taken_route(mod, fn) -> str:
    """The route (a key of ``mod.ROUTE_LAUNCHES``) one call of ``fn``
    launched its kernel on."""
    before = dict(mod.ROUTE_LAUNCHES)
    fn()
    taken = [k for k, n in mod.ROUTE_LAUNCHES.items() if n != before[k]]
    if len(taken) != 1:
        raise AssertionError(f"{mod.__name__}: one call took routes {taken}")
    return taken[0]


def same_bits(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def tensor_bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def k8_case(torch, K8, dev, rnd, label, xs, ws, bs, states, D, bt, h, n, p,
            dname, reps) -> dict:
    """K8 at one decode shape, from the raw projections ``xs`` (xs, B, C:
    [Bt, 1, C]) and the conv ``states`` that K6's decode case took: the
    new state and conv states against the plain version bit for bit, y
    within one ulp (bf16; float32 ``MAMBA_REL``: the sum over N in another
    order); two calls, and two replays of a captured call from the same
    states, bitwise; device ms (calls captured in a CUDA graph, each on the
    states the last one wrote), the bound, the plain version's ms and the
    split by CUDA kernel.  Returns its record with ``y_out``, the
    output K7 takes next."""
    f32 = torch.float32
    dt_raw = rnd(bt, 1, h)
    vectors = (rnd(h, scale=0.5, dt=f32),
               torch.log(torch.linspace(1.0, 16.0, h, device=dev)), D)
    ssm0 = rnd(bt, h, n, p, dt=f32)

    def run(fn, sts=None, ssm=None):
        sts = [t.clone() for t in states] if sts is None else sts
        ssm = ssm0.clone() if ssm is None else ssm
        return fn(*xs, dt_raw, ws, bs, sts, ssm, *vectors), sts, ssm

    (y1, st1, s1), (y2, st2, s2) = run(K8.decode_layer), run(K8.decode_layer)
    yp, stp, sp = run(K8.decode_layer_plain)
    out = held(torch, "K8 state and conv states vs plain", [s1, *st1],
               [sp, *stp], "float32", 0)
    out["y"] = held(torch, "K8 output vs plain", [y1], [yp], dname,
                    MAMBA_MAX_ULPS if dname == "bfloat16" else None)
    out["max_abs_err"] = max(out["max_abs_err"], out["y"]["max_abs_err"])
    out["bitwise_two_calls"] = same_bits(torch, [y1, s1, *st1],
                                         [y2, s2, *st2])
    # a captured call replayed twice from the states it started from
    bufs, buf_ssm = [t.clone() for t in states], ssm0.clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gy = run(K8.decode_layer, bufs, buf_ssm)[0]
    replays = []
    for _ in range(2):
        for t, t0 in zip(bufs + [buf_ssm], states + [ssm0]):
            t.copy_(t0)
        graph.replay()
        replays.append(same_bits(torch, [gy, buf_ssm, *bufs],
                                 [y1, s1, *st1]))
    del graph
    out["bitwise_graph_replays"] = replays
    log(f"  K8 captured call replayed twice from the same states: bitwise "
        f"with the eager call {replays}")
    if not all(replays):
        raise AssertionError(f"{label}: K8's graph replay differs from its "
                             f"eager call")
    sts, ssm = [t.clone() for t in states], ssm0.clone()
    out["route"] = "vector"         # K8's one route: 16-byte state vectors
    out["ms"] = graph_ms(torch, lambda: run(K8.decode_layer, sts, ssm), reps)
    out["split"] = graph_split(torch, lambda: run(K8.decode_layer, sts, ssm),
                               "decode_layer", reps)
    out["plain_ms"] = graph_ms(
        torch, lambda: run(K8.decode_layer_plain, sts, ssm), reps)
    # each input read once, the states written once more, y written
    nb = tensor_bytes(list(xs) + [dt_raw, *ws, *bs, *states, ssm0, *vectors,
                                  *st1, s1, y1])
    out["bytes"] = nb
    # per state element the update and the output's product and sum (6);
    # per conv output K multiplies and adds, the bias and the SiLU
    ops = ssm0.numel() * 6 + sum(x.numel() for x in xs) * (2 * CONV_K + 8)
    out["bound_ms"], out["bound_by"] = roofline(nb, ops, f32)
    out["y_out"] = y1
    return out


def mamba_case(torch, K6, K7, K8, dev, case, reps: int = 20) -> dict:
    """One shape of :data:`MAMBA_CASES`: each kernel against its plain
    version, two calls bitwise, kernel and plain device ms (calls captured
    in a CUDA graph, :func:`graph_ms`) beside the kernel's bytes bound, and
    (training) the plain ops' autograd forward and backward (CUDA events
    around eager calls: the train graph's eager warm-up runs them so)."""
    name, bt, s, di, h, n, g, dname, kind = case
    dtype = getattr(torch, dname)
    gen = torch.Generator(device=dev).manual_seed(0)
    label = f"{name} {dname} (Bt={bt}, S={s}, d_inner={di}, H={h}, N={n})"
    log(f"Mamba kernels, {label}:")

    def timed(key, mod, fn, mark, n_reps=reps):
        """The route ``fn`` takes, its device ms and its split by CUDA
        kernel (calls captured in a graph)."""
        rec[key]["route"] = taken_route(mod, fn)
        rec[key]["ms"] = graph_ms(torch, fn, n_reps)
        rec[key]["split"] = graph_split(torch, fn, mark, n_reps)

    def rnd(*shape, scale=1.0, shift=0.0, dt=dtype):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                + shift).to(dt)

    p = di // h
    widths = (di, g * n, g * n)
    xs = [rnd(bt, s, c) for c in widths]
    ws = [rnd(CONV_K, c, scale=0.3) for c in widths]
    bs = [rnd(c, scale=0.1) for c in widths]
    states = [rnd(bt, CONV_K - 1, c) for c in widths] if kind == "decode" \
        else None
    want_state = kind != "train"
    rec = {"case": name, "dtype": dname, "bt": bt, "s": s, "d_inner": di,
           "heads": h, "n": n}

    def k6():
        return K6.causal_conv(xs, ws, bs, states, want_state)

    ys, new = k6()
    ys2, new2 = k6()
    plain = [K6.causal_conv_plain(x, w, b, None if states is None
                                  else states[j])
             for j, (x, w, b) in enumerate(zip(xs, ws, bs))]
    got = ys + (new or [])
    want = [y for y, _ in plain] + ([st for _, st in plain]
                                    if want_state else [])
    rec["K6"] = held(torch, "K6 forward vs plain", got, want, dname,
                     MAMBA_MAX_ULPS)
    rec["K6"]["bitwise_two_calls"] = same_bits(torch, got, ys2 + (new2 or []))
    timed("K6", K6, k6, "conv_")
    rec["K6"]["plain_ms"] = graph_ms(torch, lambda: [
        K6.causal_conv_plain(x, w, b, None if states is None else states[j])
        for j, (x, w, b) in enumerate(zip(xs, ws, bs))], 3)
    nbytes = tensor_bytes(xs + ws + bs + (states or []) + got)
    rec["K6"]["bytes"] = nbytes
    # per output element K multiplies and adds, the bias and the SiLU (~6)
    ops = sum(y.numel() for y in ys) * (2 * CONV_K + 8)
    f32 = torch.float32        # the kernels' arithmetic: float32, no MMA
    rec["K6"]["bound_ms"], rec["K6"]["bound_by"] = roofline(nbytes, ops,
                                                            f32)
    if kind == "train":
        gs = [rnd(bt, s, c, scale=1e-2) for c in widths]

        def k6b():
            return K6.causal_conv_backward(xs, ws, bs, gs)

        d1, d2 = k6b(), k6b()
        flat1, flat2 = [t for ls in d1 for t in ls], [t for ls in d2 for t in
                                                       ls]
        pb = [K6.causal_conv_backward_plain(x, w, b, gg)
              for x, w, b, gg in zip(xs, ws, bs, gs)]
        rec["K6_backward"] = held(
            torch, "K6 backward dx vs plain", d1[0], [t[0] for t in pb],
            dname)
        rec["K6_backward"]["dw_db"] = held(
            torch, "K6 backward dw, db vs plain", d1[1] + d1[2],
            [t[1] for t in pb] + [t[2] for t in pb], dname)
        rec["K6_backward"]["bitwise_two_calls"] = same_bits(torch, flat1,
                                                            flat2)
        timed("K6_backward", K6, k6b, "conv_")
        rec["K6_backward"]["plain_ms"] = graph_ms(torch, lambda: [
            K6.causal_conv_backward_plain(x, w, b, gg)
            for x, w, b, gg in zip(xs, ws, bs, gs)], 3)
        nb = tensor_bytes(xs + ws + bs + gs + flat1)
        rec["K6_backward"]["bytes"] = nb
        rec["K6_backward"]["bound_ms"], rec["K6_backward"]["bound_by"] = \
            roofline(nb, sum(x.numel() for x in xs) * (4 * CONV_K + 16),
                     f32)
        leaves = [t.clone().requires_grad_() for t in xs + ws + bs]

        def plain_autograd():
            outs = [K6.causal_conv_plain(leaves[j], leaves[3 + j],
                                         leaves[6 + j])[0] for j in range(3)]
            torch.autograd.backward(outs, gs)
            for t in leaves:
                t.grad = None
        rec["K6_backward"]["plain_autograd_ms"] = cuda_ms(plain_autograd, 3)

    # K7 and K8
    D = rnd(h, scale=0.1, shift=1.0, dt=torch.float32)
    scale = rnd(di, scale=0.1, shift=1.0, dt=torch.float32)
    z = rnd(bt, s, di)
    if kind == "decode":
        rec["K8"] = k8_case(torch, K8, dev, rnd, label, xs, ws, bs, states,
                            D, bt, h, n, p, dname, reps)
        y, xsk, Dk = rec["K8"].pop("y_out").reshape(bt, 1, di), None, None
    else:
        y, xsk, Dk = rnd(bt, s, di), xs[0], D

    def k7():
        return K7.gated_norm(y, xsk, z, Dk, scale)

    (o1, r1), (o2, r2) = k7(), k7()
    po = K7.gated_norm_plain(y, xsk, z, Dk, scale)
    rec["K7"] = held(torch, "K7 forward vs plain", [o1], [po], dname)
    rec["K7"]["bitwise_two_calls"] = same_bits(torch, [o1, r1], [o2, r2])
    timed("K7", K7, k7, "gn_")
    rec["K7"]["plain_ms"] = graph_ms(
        torch, lambda: K7.gated_norm_plain(y, xsk, z, Dk, scale), 3)
    nb = tensor_bytes([y, xsk, z, Dk, scale, o1])
    rec["K7"]["bytes"] = nb
    rec["K7"]["bound_ms"], rec["K7"]["bound_by"] = roofline(
        nb, o1.numel() * 20, f32)
    if kind == "train":
        dout = rnd(bt, s, di, scale=1e-2)

        def k7b():
            return K7.gated_norm_backward(dout, y, xsk, z, Dk, scale, r1)

        b1, b2 = k7b(), k7b()
        pb = K7.gated_norm_backward_plain(dout, y, xsk, z, Dk, scale)
        rec["K7_backward"] = held(torch, "K7 backward dy, dxs, dz vs plain",
                                  list(b1[:3]), list(pb[:3]), dname)
        rec["K7_backward"]["dD_dscale"] = held(
            torch, "K7 backward dD, dscale vs plain", list(b1[3:]),
            list(pb[3:]), "float32" if dname == "float32" else dname)
        rec["K7_backward"]["bitwise_two_calls"] = same_bits(torch, b1, b2)
        timed("K7_backward", K7, k7b, "gn_")
        rec["K7_backward"]["plain_ms"] = graph_ms(
            torch, lambda: K7.gated_norm_backward_plain(dout, y, xsk, z, Dk,
                                                        scale), 3)
        nb = tensor_bytes([dout, y, xsk, z, Dk, scale, r1, *b1])
        rec["K7_backward"]["bytes"] = nb
        rec["K7_backward"]["bound_ms"], rec["K7_backward"]["bound_by"] = \
            roofline(nb, o1.numel() * 40, f32)
        leaves = [t.clone().requires_grad_() for t in (y, xsk, z, Dk,
                                                         scale)]

        def plain_autograd():
            out = K7.gated_norm_plain(*leaves)
            out.backward(dout)
            for t in leaves:
                t.grad = None
        rec["K7_backward"]["plain_autograd_ms"] = cuda_ms(plain_autograd, 3)
    for k in ("K6", "K6_backward", "K7", "K7_backward", "K8"):
        if k in rec:
            r = rec[k]
            before = MAMBA_BEFORE_MS.get((name, k)) if dname == "bfloat16" \
                else None
            log(f"  {k}: ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}; {r['bytes'] / 1e9:.4f} GB at 3.35 TB/s) "
                f"share_of_bound={r['bound_ms'] / r['ms']:.3f} plain_ms="
                f"{r['plain_ms']:.4f}"
                + (f" plain_autograd_forward_backward_ms="
                   f"{r['plain_autograd_ms']:.4f}"
                   if "plain_autograd_ms" in r else "")
                + f" bitwise_two_calls={r['bitwise_two_calls']}"
                + (f" route={r['route']} before_ms="
                   + ("none" if before is None else
                      f"{before:.4f} ({r['ms'] / before:.3f}x)")
                   + f" split: {split_text(r['split'])}"
                   if "route" in r else ""))
            if not r["bitwise_two_calls"]:
                raise AssertionError(f"{label}: {k} differs between two "
                                     f"calls")
    return rec


def phase_mamba_kernels(torch, K6, K7, K8, dev) -> dict:
    """9e: K6, K7 (forward and backward) and K8 against their plain
    versions at :data:`MAMBA_CASES`; the records of K6, K7 and K8 at
    mamba2-1.3b's shapes (training for K6 and K7, decode for K8)."""
    log("== phase 9e: the Mamba block's kernels (K6 conv + SiLU, K7 D skip "
        "+ gated norm, K8 decode state step) vs plain")
    cases = [mamba_case(torch, K6, K7, K8, dev, c) for c in MAMBA_CASES]
    train, decode = cases[0], cases[2]
    prefill = cases[1]

    fused = ("; no Pallas kernel: XLA fuses it inside the jax.jit of "
             "src/repro/train/loop.py:108 and src/repro/serve/engine.py:74")

    def record(name, key, site, main, extra):
        r = main[key]
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": site + fused, "launches": 0,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None, **extra}
    k6 = record("mamba_conv", "K6", "src/repro/models/mamba.py:147 "
                "(_causal_conv with its SiLU)", train,
                {"shape": "mamba2-1.3b training: xs, B, C of 4 x 2048 "
                 "tokens (4096 + 128 + 128 channels), K=4, bf16",
                 "backward": train["K6_backward"], "prefill": prefill["K6"],
                 "decode": decode["K6"]})
    k7 = record("gated_norm", "K7", "src/repro/models/mamba.py:173 "
                "(_gated_norm) and the D skip at :210", train,
                {"shape": "mamba2-1.3b training: 4 x 2048 rows of 4096, 64 "
                 "heads, bf16", "backward": train["K7_backward"],
                 "prefill": prefill["K7"], "decode": decode["K7"]})
    jamba = cases[4]["K8"]
    k8 = record("mamba_decode", "K8", "src/repro/models/mamba.py:236-257 "
                "(mamba_decode from its three _causal_conv calls with their "
                "SiLU to the D skip)",
                decode, {"shape": "mamba2-1.3b decode: batch 1, 64 heads, "
                         "N=128, P=64, float32 state, bf16; the convs of xs, "
                         "B, C (4096 + 128 + 128 channels, K=4) from their "
                         "states, every state written in place",
                         "split": decode["K8"]["split"],
                         "jamba_layer_decode": {
                             k: jamba[k] for k in (
                                 "ms", "plain_ms", "bound_ms", "bound_by",
                                 "max_abs_err", "split")}})
    return {"K6": k6, "K7": k7, "K8": k8, "cases": cases}


# ---------------------------------------------------------------------------
# phase 9f: the unit's fused work (K9 residual add + RMSNorm, K10 SwiGLU gate)
# ---------------------------------------------------------------------------

# name, rows (Bt, S), d_model, d_ff (None: no gated MLP), dtype, offset (in
# elements: a view that starts off a 16-byte boundary), whether the
# backwards run.  yi-6b's and mamba2-1.3b's training shapes (4 x 2048
# tokens) and decode rows are the main path's; deepseek-v3-671b's d_model
# 7168 (its dense prelude's d_ff 18432) over 2048 tokens; yi-6b's widths in
# float32; a row of 4100 bf16 and a view one element in: the scalar route
UNIT_CASES = (
    ("yi-6b train", 4, 2048, 4096, 11008, "bfloat16", 0, True),
    ("mamba2-1.3b train", 4, 2048, 2048, None, "bfloat16", 0, True),
    ("yi-6b decode", 1, 1, 4096, 11008, "bfloat16", 0, False),
    ("mamba2-1.3b decode", 1, 1, 2048, None, "bfloat16", 0, False),
    ("deepseek-v3 train", 1, 2048, 7168, 18432, "bfloat16", 0, True),
    ("yi-6b float32", 1, 2048, 4096, 11008, "float32", 0, True),
    ("scalar route", 2, 256, 4100, 1030, "bfloat16", 1, True),
)
# K9's s and K10's outputs round each op as the plain version's: within
# UNIT_MAX_ULPS of it element by element (K9's s bit for bit); K9's y and
# backward take the row's sums in another order: y within UNIT_MAX_ULPS in
# bf16, and ``MAMBA_REL``'s relative L2 for the rest
UNIT_MAX_ULPS = 1


def replayed_bitwise(torch, fn, want) -> bool:
    """``fn()`` captured in a CUDA graph and replayed twice: each replay's
    outputs bit for bit ``want`` (an eager call's)."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    same = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same.append(same_bits(torch, outs, want))
    del graph, outs
    return all(same)


def unit_case(torch, K9, K10, dev, case, reps: int = 20) -> dict:
    """One shape of :data:`UNIT_CASES`: K9 with and without ``h`` and K10
    against their plain versions, forward and (training) backward; two
    calls and two replays of a captured call bitwise; kernel, plain and
    library device ms (calls captured in a CUDA graph, :func:`graph_ms`)
    beside the bytes bound."""
    import torch.nn.functional as F
    name, bt, s, d, f, dname, offset, train = case
    dtype = getattr(torch, dname)
    gen = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.float32
    label = f"{name} {dname} ({bt} x {s} rows of {d}, d_ff {f})"
    log(f"unit kernels, {label}:")

    def rnd(*shape, scale=1.0, shift=0.0, dt=dtype):
        """A tensor ``offset`` elements into a buffer of its own."""
        n = math.prod(shape)
        buf = (torch.randn(n + offset, generator=gen, device=dev) * scale
               + shift).to(dt)
        return buf[offset:].view(*shape)

    rec = {"case": name, "dtype": dname, "rows": bt * s, "d_model": d,
           "d_ff": f}

    def timed(key, mod, fn, plain, nbytes, ops, library=None):
        r = rec[key]
        r["route"] = taken_route(mod, fn)
        r["ms"] = graph_ms(torch, fn, reps)
        r["plain_ms"] = graph_ms(torch, plain, 3)
        r["library_ms"] = None if library is None else graph_ms(
            torch, library, reps)
        r["bytes"] = nbytes
        r["bound_ms"], r["bound_by"] = roofline(nbytes, ops, f32)
        log(f"  {key}: ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}; {nbytes / 1e9:.4f} GB at 3.35 TB/s) "
            f"share_of_bound={r['bound_ms'] / r['ms']:.3f} plain_ms="
            f"{r['plain_ms']:.4f} library_ms="
            + ("none" if r["library_ms"] is None else
               f"{r['library_ms']:.4f}")
            + f" route={r['route']} bitwise_two_calls="
            f"{r['bitwise_two_calls']} bitwise_replays="
            f"{r['bitwise_replays']}")
        if not (r["bitwise_two_calls"] and r["bitwise_replays"]):
            raise AssertionError(f"{label}: {key} differs between calls or "
                                 f"replays")

    x, h = rnd(bt, s, d), rnd(bt, s, d)
    scale = rnd(d, scale=0.1, shift=1.0, dt=f32)
    maxu = UNIT_MAX_ULPS if dname == "bfloat16" else None
    # K9 with h: s bit for bit, y within an ulp (bf16)
    k9 = lambda: K9.add_rmsnorm(x, h, scale)            # noqa: E731
    out1, out2 = k9(), k9()
    ps, py = K9.add_rmsnorm_plain(x, h, scale)
    rec["K9"] = held(torch, "K9 s vs plain", [out1[0]], [ps], dname, 0)
    rec["K9"].update(held(torch, "K9 y vs plain", [out1[1]], [py],
                               dname, maxu))
    rec["K9"]["bitwise_two_calls"] = same_bits(torch, out1, out2)
    rec["K9"]["bitwise_replays"] = replayed_bitwise(torch, k9, out1)
    timed("K9", K9, k9, lambda: K9.add_rmsnorm_plain(x, h, scale),
          tensor_bytes([x, h, scale, *out1]), x.numel() * 6)
    # K9 without h: y against the plain rmsnorm and torch's rms_norm
    k9n = lambda: K9.add_rmsnorm(x, None, scale)         # noqa: E731
    scale_t = scale.to(dtype)             # torch's rms_norm: one dtype
    n1, n2 = k9n(), k9n()
    rec["K9_without_h"] = held(
        torch, "K9 without h: y vs plain", [n1[1]],
        [K9.rmsnorm_plain(x, scale)], dname, maxu)
    rec["K9_without_h"]["bitwise_two_calls"] = same_bits(torch, n1, n2)
    rec["K9_without_h"]["bitwise_replays"] = replayed_bitwise(torch, k9n,
                                                              n1)
    timed("K9_without_h", K9, k9n, lambda: K9.rmsnorm_plain(x, scale),
          tensor_bytes([x, scale, *n1[1:]]), x.numel() * 5,
          lambda: F.rms_norm(x, (d,), scale_t, K9.EPS))
    if train:
        dy, ds = rnd(bt, s, d, scale=1e-2), rnd(bt, s, d, scale=1e-2)
        sv, rstd = out1[0], out1[2]
        k9b = lambda: K9.add_rmsnorm_backward(dy, ds, sv, scale,  # noqa
                                              rstd)
        b1, b2 = k9b(), k9b()
        pd, pdscale = K9.add_rmsnorm_backward_plain(dy, ds, sv, scale)
        rec["K9_backward"] = held(torch, "K9 backward d vs plain",
                                       [b1[0]], [pd], dname, None)
        rec["K9_backward"]["dscale"] = held(
            torch, "K9 backward dscale vs plain", [b1[1]], [pdscale],
            dname, None)
        rec["K9_backward"]["bitwise_two_calls"] = same_bits(torch, b1, b2)
        rec["K9_backward"]["bitwise_replays"] = replayed_bitwise(torch, k9b,
                                                                 b1)
        timed("K9_backward", K9, k9b,
              lambda: K9.add_rmsnorm_backward_plain(dy, ds, sv, scale,
                                                    rstd),
              tensor_bytes([dy, ds, sv, scale, rstd, *b1]), x.numel() * 10)
        leaves = [t.clone().requires_grad_() for t in (x, h, scale)]

        def plain_autograd():
            s_, y_ = K9.add_rmsnorm_plain(*leaves)
            torch.autograd.backward((s_, y_), (ds, dy))
            for t in leaves:
                t.grad = None
        rec["K9_backward"]["plain_autograd_ms"] = cuda_ms(plain_autograd, 3)
    if f is not None:
        g, u = rnd(bt, s, f), rnd(bt, s, f)
        k10 = lambda: K10.swiglu_gate(g, u)              # noqa: E731
        h1, h2 = k10(), k10()
        rec["K10"] = held(torch, "K10 forward vs plain", [h1],
                               [K10.swiglu_gate_plain(g, u)], dname,
                               UNIT_MAX_ULPS)
        rec["K10"]["bitwise_two_calls"] = same_bits(torch, [h1], [h2])
        rec["K10"]["bitwise_replays"] = replayed_bitwise(
            torch, lambda: [k10()], [h1])
        timed("K10", K10, k10, lambda: K10.swiglu_gate_plain(g, u),
              tensor_bytes([g, u, h1]), g.numel() * 6)
        if train:
            dh = rnd(bt, s, f, scale=1e-2)
            k10b = lambda: K10.swiglu_gate_backward(dh, g, u)  # noqa
            c1, c2 = k10b(), k10b()
            rec["K10_backward"] = held(
                torch, "K10 backward dg, du vs plain", list(c1),
                list(K10.swiglu_gate_backward_plain(dh, g, u)), dname,
                UNIT_MAX_ULPS if dname == "bfloat16" else None)
            rec["K10_backward"]["bitwise_two_calls"] = same_bits(torch, c1,
                                                                 c2)
            rec["K10_backward"]["bitwise_replays"] = replayed_bitwise(
                torch, k10b, c1)
            timed("K10_backward", K10, k10b,
                  lambda: K10.swiglu_gate_backward_plain(dh, g, u),
                  tensor_bytes([dh, g, u, *c1]), g.numel() * 12)
            leaves = [t.clone().requires_grad_() for t in (g, u)]

            def gate_autograd():
                K10.swiglu_gate_plain(*leaves).backward(dh)
                for t in leaves:
                    t.grad = None
            rec["K10_backward"]["plain_autograd_ms"] = cuda_ms(gate_autograd,
                                                               3)
    return rec


def phase_unit_kernels(torch, K9, K10, dev) -> dict:
    """9f: K9 (with and without ``h``) and K10, forward and backward,
    against their plain versions at :data:`UNIT_CASES`; the records of K9
    and K10 at yi-6b's training shape."""
    log("== phase 9f: the unit's kernels (K9 residual add + RMSNorm, K10 "
        "SwiGLU gate) vs plain")
    t0 = time.perf_counter()
    cases = [unit_case(torch, K9, K10, dev, c) for c in UNIT_CASES]
    log(f"phase 9f seconds={time.perf_counter() - t0:.1f}")
    yi, mamba = cases[0], cases[1]
    fused = ("; no Pallas kernel: XLA fuses it inside the jax.jit of "
             "src/repro/train/loop.py:108 and src/repro/serve/engine.py:74")

    def record(name, key, site, extra):
        r = yi[key]
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": site + fused, "launches": 0,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                **extra}

    def brief(r):
        return {k: r.get(k) for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "max_abs_err",
                                      "route", "rel_l2", "ulps")}
    k9 = record("unit_norm", "K9", "src/repro/models/layers.py:44 (rmsnorm) "
                "and the residual adds at src/repro/models/transformer.py:"
                "153, :161, :291, :296, :365, :370",
                {"shape": "yi-6b training: 4 x 2048 rows of 4096 with the "
                 "pending branch output h, bf16",
                 "without_h": brief(yi["K9_without_h"]),
                 "backward": brief(yi["K9_backward"]),
                 "mamba2_1_3b": {k: brief(mamba[k]) for k in
                                 ("K9", "K9_backward")},
                 "decode": {c["case"]: brief(c["K9"]) for c in cases
                            if "decode" in c["case"]}})
    k10 = record("swiglu_gate", "K10", "src/repro/models/layers.py:73 "
                 "(swiglu's silu(g.astype(f32)).astype(x.dtype) * u)",
                 {"shape": "yi-6b training: 4 x 2048 x 11008, bf16",
                  "backward": brief(yi["K10_backward"]),
                  "decode": brief(cases[2]["K10"])})
    return {"K9": k9, "K10": k10, "cases": cases}


# ---------------------------------------------------------------------------
# phase 9d: K5 on the local shards of two ranks of one card (gloo)
# ---------------------------------------------------------------------------

K5_MESH_RANKS = 2
# mamba2-1.3b's gradients at this scale: norm ~0.116, under the clip
K5_MESH_GRAD_SCALE = 1e-5


def k5_mesh_split(ps) -> list[bool]:
    """Which of a parameter set's tensors the ranks replicate: vectors and
    every eighth matrix; the rest are cut into row blocks, one a rank
    (uneven where the rows do not divide)."""
    return [p.dim() < 2 or i % 8 == 0 for i, p in enumerate(ps)]


def k5_mesh_rank(rank: int, store: str, conn, cfg, device: str) -> None:
    """Spawned child, rank ``rank`` of a gloo group on the one card: K5 on
    this rank's local shards of mamba2-1.3b's parameter set (the norm's
    total all-reduced over the group with CUDA tensors), then single-rank
    K5 on the whole set; this rank's results against the whole set's,
    and every replicated tensor against rank 0's copy.  (``cfg``,
    ``device``: another parameter set, or the CPU, where K5 is its plain
    version, to rehearse the phase.)"""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import adamw as K5
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=K5_MESH_RANKS)
    try:
        dev = torch.device(device)
        gs, ps, ms, vs, decays, _ = k5_model_set(
            torch, cfg, torch.float32, dev, grad_scale=K5_MESH_GRAD_SCALE)
        replicated = k5_mesh_split(ps)

        def local(t, rep):
            return (t if rep else torch.tensor_split(
                t, K5_MESH_RANKS)[rank]).clone()
        lg, lp, lm, lv = ([local(t, r) for t, r in zip(ts, replicated)]
                          for ts in (gs, ps, ms, vs))
        counted = [not r or rank == 0 for r in replicated]
        step = torch.tensor(3, dtype=torch.int32, device=dev)
        K5.reset_counts()
        norm = K5.adamw_step_(lg, lp, lm, lv, step, decays, counted=counted,
                              groups=[None], **K5_HYPER)
        mesh_launches = K5.LAUNCHES
        ref_step = torch.tensor(3, dtype=torch.int32, device=dev)
        ref = K5.adamw_step_(gs, ps, ms, vs, ref_step, decays, **K5_HYPER)
        same = all(
            bitwise(torch, a, local(b, r))
            for ls, whole in ((lp, ps), (lm, ms), (lv, vs))
            for a, b, r in zip(ls, whole, replicated))
        same_as_rank0 = True
        for ls in (lp, lm, lv):
            for t, r in zip(ls, replicated):
                if r:
                    copy = t.clone()
                    dist.broadcast(copy, src=0)
                    same_as_rank0 = same_as_rank0 and bitwise(torch, copy,
                                                              t)
        conn.send({"rank": rank, "norm": float(norm), "ref_norm": float(ref),
                   "bitwise": same, "step": int(step),
                   "replicated_equal_rank0": same_as_rank0,
                   "mesh_launches": mesh_launches,
                   "tensors": len(ps), "replicated": sum(replicated),
                   "local_elements": sum(t.numel() for t in lp),
                   "counted_elements": sum(t.numel() for t, c in
                                           zip(lp, counted) if c),
                   "elements": sum(t.numel() for t in ps)})
    except Exception as e:
        conn.send({"rank": rank, "error": repr(e)})
        raise
    finally:
        conn.close()
        dist.destroy_process_group()


def phase_k5_mesh(torch, cfg=None, device: str = "cuda") -> dict:
    """9d: K5's local-shard update on two ranks of the one card over gloo
    (one card cannot hold two NCCL ranks), each rank a spawned process:
    mamba2-1.3b's parameter set split between them (row blocks, vectors
    and every eighth matrix replicated), held to single-rank K5 on the
    whole set: the norm within 1e-7 relative, every result bit for bit
    (the norm is under the clip), each replicated tensor bit for bit with
    rank 0's, four launches a rank (none on the CPU, where ``device``
    rehearses the phase on ``cfg``'s set with K5's plain version)."""
    import multiprocessing
    import shutil

    from repro_torch.configs import get_config
    cfg = cfg or get_config("mamba2-1.3b")

    log(f"== phase 9d: K5 on the local shards of {K5_MESH_RANKS} ranks of "
        f"one card (gloo), {cfg.name}'s parameter set")
    store = ROOT / "build" / "k5_mesh_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs, pipes = [], []
    try:
        for rank in range(K5_MESH_RANKS):
            recv, send = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=k5_mesh_rank,
                               args=(rank, str(store / "store"), send, cfg,
                                     device))
            proc.start()
            send.close()
            procs.append(proc)
            pipes.append(recv)
        rows = []
        for recv in pipes:
            if not recv.poll(600):
                raise RuntimeError("phase 9d: a rank sent nothing in 600 s")
            rows.append(recv.recv())
        for proc in procs:
            proc.join(60)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
        shutil.rmtree(store, ignore_errors=True)
    seconds = time.perf_counter() - t0
    errors = [r for r in rows if "error" in r]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"phase 9d: {errors} exit codes "
                           f"{[p.exitcode for p in procs]}")
    for r in rows:
        r["norm_rel"] = abs(r["norm"] / r["ref_norm"] - 1)
        log(f"K5 mesh rank {r['rank']}/{K5_MESH_RANKS}: norm={r['norm']!r} "
            f"single_rank_norm={r['ref_norm']!r} norm_rel={r['norm_rel']:.3g}"
            f" bitwise={r['bitwise']} replicated_equal_rank0="
            f"{r['replicated_equal_rank0']} step={r['step']} launches="
            f"{r['mesh_launches']} tensors={r['tensors']} replicated="
            f"{r['replicated']} local_elements={r['local_elements']} "
            f"counted_elements={r['counted_elements']} of {r['elements']}")
    counted = sum(r["counted_elements"] for r in rows)
    log(f"K5 mesh: counted elements over the ranks {counted} (each element "
        f"once: {counted == rows[0]['elements']}) seconds={seconds:.1f}")
    if counted != rows[0]["elements"] or not all(
            r["norm_rel"] <= 1e-7 and r["bitwise"] and r["step"] == 4
            and r["replicated_equal_rank0"]
            and r["mesh_launches"] == (4 if device == "cuda" else 0)
            and r["norm"] < K5_HYPER["grad_clip"] for r in rows):
        raise AssertionError(f"phase 9d: K5 on local shards disagrees "
                             f"with single-rank K5: {rows}")
    return {"ranks": rows, "seconds": seconds}


PROMPT_LEN, MAX_NEW, N_CLIENTS, ROUNDS = 2000, 16, 3, 5


def arrivals() -> list[tuple[int, float]]:
    """(client, time) of each request: three clients in turn, 20 s apart,
    each client's own gaps 63 s and 57 s alternately (60 s +- 5%), so its
    std/median gap (0.045-0.05) is past the scheduler's median fast path
    (0.02) and inside its regular-client limit (0.25).  Five rounds: a
    client's fourth arrival prewarms its fifth request, and only its fifth
    gives the ARIMA fit four gaps (fewer fall back to the last gap)."""
    return [(c, 20.0 * c + 60.0 * r + 3.0 * (r % 2))
            for r in range(ROUNDS) for c in range(N_CLIENTS)]


def stub_inputs(torch, cfg, n: int, dev, mult: int = 5):
    """A deterministic ``n``-token prompt [1, n] ([1, n, CB] with codebooks)
    and the modality stub's prefix embeddings (zeros, None without a
    prefix), as ``ServeEngine`` feeds them."""
    tokens = torch.arange(n, device=dev) * mult % cfg.vocab
    if cfg.codebooks > 1:
        tokens = (tokens[:, None] + torch.arange(cfg.codebooks, device=dev)
                  ) % cfg.vocab
    pe = (torch.zeros((1, cfg.n_prefix, cfg.d_model), dtype=torch.bfloat16,
                      device=dev) if cfg.n_prefix else None)
    return tokens[None], pe


def attn_layers(cfg) -> int:
    """GQA attention layers (K2 launches per prefill)."""
    specs = list(cfg.prelude) + list(cfg.pattern) * cfg.n_units
    return sum(m.startswith("attn") for m, _ in specs)


def init_model(torch, cfg, label: str, dev):
    """Random parameters from seed 0 on the card; logs their count."""
    from repro_torch.models.transformer import init_params
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{label}: params={n_params} dtype={cfg.dtype} n_layers="
        f"{cfg.n_layers} init_seconds={time.perf_counter() - t0:.2f} "
        f"allocated_gib={torch.cuda.memory_allocated() / 2**30:.2f}")
    return params


def free(torch) -> None:
    """Collect and return the card's cached blocks, once the caller has
    dropped its references to a model."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def serve_phase(torch, cfg, params, label: str, per_prefill: dict,
                counts: dict, dev, phase: str, route: str | None = None
                ) -> dict:
    """Serve ``cfg`` at full width through ``ServeEngine`` on the traffic of
    ``arrivals()``; check that each prefill launched each kernel of
    ``per_prefill`` that many times (on ``route`` where one is named) and
    the scheduler launched K1; then a prefill through the kernels against
    the same prefill through their plain versions (where a kernel runs) and
    one cold request profiled.  Returns the launches and the requests'
    TTFT and decode rate."""
    import statistics

    import numpy as np

    from repro_torch.serve import engine as TE

    log(f"== {phase}: serve {label} at full width")
    engine = TE.ServeEngine(cfg, params, max_len=PROMPT_LEN + MAX_NEW + 8,
                            device=dev)
    prefills, finite = [0], []
    inner_prefill, inner_advance = engine._prefill, TE.DecodeProgram.advance

    def counted_prefill(prompt):
        logits, caches, length = inner_prefill(prompt)
        prefills[0] += 1
        finite.append(torch.isfinite(logits).all())
        return logits, caches, length

    def checked_advance(program):
        # the logits buffer after each replay of the captured step
        inner_advance(program)
        finite.append(torch.isfinite(program.logits).all())

    engine._prefill = counted_prefill
    TE.DecodeProgram.advance = checked_advance
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for mod in counts.values():
        mod.reset_counts()                   # counts of this run only
    t_run = time.perf_counter()
    try:
        comps = []
        for i, (client, now) in enumerate(arrivals()):
            prompt = (np.arange(PROMPT_LEN) * (client + 3)) % cfg.vocab
            comps.append(engine.serve(
                TE.Request(i, client, now, prompt, MAX_NEW), now))
        torch.cuda.synchronize()
    finally:
        TE.DecodeProgram.advance = inner_advance
    seconds = time.perf_counter() - t_run
    if engine.program is None or engine.program.graph is None:
        raise AssertionError(f"{label}: the engine decoded without a graph")
    log(f"{label}: decode graph captured once, capture_seconds="
        f"{engine.program.capture_seconds:.3f}")
    launches = {name: mod.LAUNCHES for name, mod in counts.items()}
    rates = []
    for c in comps:
        rates.append(MAX_NEW / (c.done_at - c.first_token_at))
        log(f"{label} req {c.request_id}: prefetched={c.prefetched} "
            f"ttft_ms={c.ttft * 1e3:.2f} decode_tokens_per_s={rates[-1]:.2f} "
            f"tokens={c.tokens[:4]}...")
    cold = [c.ttft * 1e3 for c in comps if not c.prefetched]
    warm = [c.ttft * 1e3 for c in comps if c.prefetched]
    summary = {"requests": len(comps), "prefills": prefills[0],
               "seconds": seconds,
               "ttft_cold_ms_median": statistics.median(cold),
               "ttft_prewarmed_ms_median": (statistics.median(warm)
                                            if warm else None),
               "decode_tokens_per_s_median": statistics.median(rates),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "capture_seconds": engine.program.capture_seconds,
               "launches": launches}
    log(f"{label}: requests={len(comps)} seconds={seconds:.3f} prefills="
        f"{prefills[0]} launches={launches} stats={engine.stats} "
        f"peak_gib={summary['peak_gib']:.2f} ttft_cold_ms_median="
        f"{summary['ttft_cold_ms_median']:.2f} ttft_prewarmed_ms_median="
        f"{summary['ttft_prewarmed_ms_median']} decode_tokens_per_s_median="
        f"{summary['decode_tokens_per_s_median']:.2f}")
    for name, n in per_prefill.items():
        if launches[name] != n * prefills[0]:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times for {prefills[0]} "
                                 f"prefills of {n} launches")
        if route and n and counts[name].ROUTE_LAUNCHES[route] != \
                launches[name]:
            raise AssertionError(f"{label}: {name} launches "
                                 f"{counts[name].ROUTE_LAUNCHES} are not all "
                                 f"on the {route} route")
    if launches["K1"] == 0:
        raise AssertionError(f"{label}: the scheduler never launched K1")
    if engine.stats["prefetched_prefills"] == 0:
        raise AssertionError(f"{label}: no prefill was prewarmed")
    if not all(0 <= t < cfg.vocab for c in comps for t in c.tokens) or \
            any(len(c.tokens) != MAX_NEW for c in comps):
        raise AssertionError(f"{label}: a token out of range or missing")
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{label}: non-finite logits")

    mods = [counts[name] for name, n in per_prefill.items() if n]
    if mods:
        check_prefill_pair(label, *prefill_pair(torch, cfg, params, mods,
                                                dev))
    summary.update(profile_request(torch, label, cfg, params,
                                   engine.program))
    del engine
    return summary


def prefill_pair(torch, cfg, params, mods, dev):
    """Last-token logits of the same full-width 256-token prefill (after the
    prefix, where the model has one) through the kernel modules ``mods``
    and through their plain versions (a short prompt keeps the plain ones
    cheap)."""
    from repro_torch.models.transformer import prefill
    tokens, pe = stub_inputs(torch, cfg, 256, dev, mult=7)
    via_kernel = prefill(params, cfg, tokens, pe)[0].float()
    swapped = []
    for mod in mods:
        fn_name = "flash_attention" if hasattr(mod, "flash_attention") \
            else "ssd_scan"
        swapped.append((mod, fn_name, getattr(mod, fn_name)))
        setattr(mod, fn_name, getattr(mod, fn_name + "_plain"))
    try:
        via_plain = prefill(params, cfg, tokens, pe)[0].float()
    finally:
        for mod, fn_name, wrapper in swapped:
            setattr(mod, fn_name, wrapper)
    return via_kernel, via_plain


def check_prefill_pair(arch: str, via_kernel, via_plain,
                       what: str = "prefill logits via the kernel vs via its "
                                   "plain version, 256 tokens") -> None:
    """The kernel's prefill logits within 5e-2 relative L2 of the plain
    version's, with the same argmax: the kernel's top token is a top token
    of the plain version (bf16 logits can tie at the top).  With codebooks,
    per codebook."""
    rel = float((via_kernel - via_plain).norm() / via_plain.norm())
    flat_k = via_kernel.reshape(-1, via_kernel.shape[-1])
    flat_p = via_plain.reshape(-1, via_plain.shape[-1])
    picked = flat_p.gather(1, flat_k.argmax(-1, keepdim=True))[:, 0]
    same = bool((picked == flat_p.amax(-1)).all())
    top2 = flat_p.topk(2, dim=-1).values
    log(f"{arch}: {what}: rel_l2={rel:.3g} max_abs="
        f"{float((via_kernel - via_plain).abs().max()):.3g} "
        f"same_argmax={same} plain_top2_gap="
        f"{float((top2[:, 0] - top2[:, 1]).min()):.3g}")
    if not rel < 5e-2:
        raise AssertionError(f"{arch}: {what}: disagree")
    if not same:
        raise AssertionError(f"{arch}: {what}: argmax differs")


def prefill_phase(torch, cfg, label: str, K2, dev, phase: str,
                  decode_steps: int = 0) -> int:
    """One full-width prefill of a PROMPT_LEN prompt (after the prefix,
    where the model has one): one K2 launch per attention layer, all on the
    route ``K2.route`` names, finite logits, the 256-token prefill through
    K2 against its plain version, then ``decode_steps`` greedy decode steps
    through a captured ``DecodeProgram`` and through the eager loop (tokens
    equal, finite logits, tokens in range).  Returns K2's launches."""
    from repro_torch.models.transformer import decode_step, prefill

    log(f"== {phase}: {label} prefill at full width (K2 at head dim "
        f"{cfg.attn.head_dim}, {cfg.attn.n_heads}/{cfg.attn.n_kv_heads} "
        f"heads)")
    params = init_model(torch, cfg, label, dev)
    tokens, pe = stub_inputs(torch, cfg, PROMPT_LEN, dev)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    K2.reset_counts()                        # counts of this run only
    t0 = time.perf_counter()
    logits, caches, n = prefill(params, cfg, tokens, pe,
                                max_len=PROMPT_LEN + cfg.n_prefix
                                + decode_steps + 1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = K2.LAUNCHES
    named = K2.route(cfg.attn.head_dim, cfg.dtype)
    log(f"{label}: prefill tokens={PROMPT_LEN} prefix={cfg.n_prefix} "
        f"wall_ms={wall_ms:.2f} K2_launches={launches} routes="
        f"{dict(K2.ROUTE_LAUNCHES)} logits={tuple(logits.shape)} "
        f"peak_gib={torch.cuda.max_memory_allocated() / 2**30:.2f}")
    if launches != attn_layers(cfg) or K2.ROUTE_LAUNCHES[named] != launches:
        raise AssertionError(f"{label}: K2 launched {K2.ROUTE_LAUNCHES} for "
                             f"one prefill of {attn_layers(cfg)} attention "
                             f"layers on route {named}")
    finite = [torch.isfinite(logits).all()]
    if decode_steps:
        from repro_torch.serve.engine import DecodeProgram
        program = DecodeProgram(params, cfg, caches, logits[0].argmax(-1))
        graph_vs_eager(torch, label, params, cfg, program,
                       (logits, caches, n), decode_steps)
        finite.append(torch.isfinite(program.logits).all())
        log(f"{label}: decode graph captured once, capture_seconds="
            f"{program.capture_seconds:.3f}")
        del program
    tok, out = logits.argmax(-1), []
    t0 = time.perf_counter()
    for i in range(decode_steps):
        logits, caches = decode_step(params, cfg, tok, caches, n + i)
        finite.append(torch.isfinite(logits).all())
        tok = logits.argmax(-1)
        out.append(tok)
    if decode_steps:
        torch.cuda.synchronize()
        rate = decode_steps / (time.perf_counter() - t0)
        toks = torch.stack(out).flatten().tolist()
        log(f"{label}: decode steps={decode_steps} tokens_per_s={rate:.2f} "
            f"tokens={toks[:8]}...")
        if not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"{label}: a decoded token out of range")
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{label}: non-finite logits")
    check_prefill_pair(label, *prefill_pair(torch, cfg, params, [K2], dev))
    del params, logits, caches
    free(torch)
    return launches


def kernel_split(torch, fn, key: str,
                 split_ok=None) -> dict[str, tuple[int, float]] | None:
    """By CUDA kernel whose name holds ``key``: how many times one call of
    ``fn`` ran it and its device milliseconds, as ``torch.profiler``
    traced them (names cut to the function's own and its template
    arguments).  A profiling run on the card now
    and then records no kernel at all (seen for K3 calls that ran and
    were right), or loses some records: a run whose split is empty, or
    that ``split_ok`` refuses, is repeated, and after three such runs the
    split is ``None``, not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            lead_in(torch)
            fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        split: dict[str, tuple[int, float]] = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or key not in e.key:
                continue
            name = e.key.replace("(anonymous namespace)::", "")
            name = re.sub(r"^void |\(.*$| ", "", name).split("::")[-1]
            count, ms = split.get(name, (0, 0.0))
            split[name] = (count + e.count,
                           ms + e.self_device_time_total / 1e3)
        if split and (split_ok is None or split_ok(split)):
            return split
    return None


def device_kernels(torch, fn, key: str) -> tuple[int | None, float]:
    """CUDA kernels whose name holds ``key`` that one call of ``fn`` ran,
    and their device milliseconds (:func:`kernel_split` summed); the
    count is ``None`` where the profiler recorded none."""
    split = kernel_split(torch, fn, key)
    if split is None:
        return None, 0.0
    return (sum(c for c, _ in split.values()),
            sum(ms for _, ms in split.values()))


def eager_decode(params, cfg, logits, caches, n: int, steps: int):
    """The per-token loop the engine ran before its decode program: int
    positions, caches written in place, each token read back to the host
    before its step.  Returns those tokens (a list) and the last step's
    logits."""
    from repro_torch.models.transformer import decode_step
    tok, toks = logits.argmax(-1), []
    for i in range(steps):
        toks.append(tok[0].tolist())
        logits, caches = decode_step(params, cfg, tok, caches, n + i)
        tok = logits.argmax(-1)
    return toks, logits


def graph_vs_eager(torch, label: str, params, cfg, program, out,
                   steps: int) -> dict:
    """``steps`` tokens from the prefill ``out`` through the captured
    decode program and through the eager loop (the program first: it
    copies the caches, the loop writes them): the tokens must be equal;
    the last step's logits are compared bit for bit (largest difference
    printed)."""
    logits, caches, n = out
    got = program.decode(caches, logits[0].argmax(-1), n, steps).tolist()
    got_logits = program.logits.clone()
    want, want_logits = eager_decode(params, cfg, logits, caches, n, steps)
    same = got == want
    diff = float((got_logits.float() - want_logits.float()).abs().max())
    log(f"{label}: graph vs eager decode, {steps} steps: tokens_equal={same} "
        f"last_logits_bitwise={bool(torch.equal(got_logits, want_logits))} "
        f"last_logits_max_abs={diff:.3g} tokens={got[:4]}")
    if not same:
        raise AssertionError(f"{label}: graph-decoded tokens differ from the "
                             f"eager loop's")
    return {"graph_tokens_equal": same, "graph_logits_max_abs": diff}


def profile_request(torch, arch: str, cfg, params, program) -> dict:
    """One cold prefill of a PROMPT_LEN prompt, then MAX_NEW decode steps
    through the engine's captured ``program`` and through the eager loop,
    from that prefill: unprofiled wall time and tokens/s of each decode,
    then each part under ``torch.profiler``: wall time, device busy time
    and share, and device time by kernel (the profiler's own host cost
    inflates wall; the decodes' busy time is also given over the
    unprofiled wall).  The graph's tokens must equal the eager loop's.
    Returns the busy shares, both decode rates and the comparison."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import prefill
    tokens, pe = stub_inputs(torch, cfg, PROMPT_LEN, program.device)
    state, shares = {}, {}

    def run_prefill():
        state["out"] = prefill(params, cfg, tokens, pe,
                               max_len=PROMPT_LEN + MAX_NEW + 8
                               + cfg.n_prefix)

    def run_graph():
        logits, caches, n = state["out"]
        program.decode(caches, logits[0].argmax(-1), n, MAX_NEW).tolist()

    def run_eager():
        eager_decode(params, cfg, *state["out"], MAX_NEW)

    run_prefill()
    rates = {}
    for part, fn in (("decode_graph", run_graph), ("decode_eager", run_eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates[part] = MAX_NEW / (time.perf_counter() - t0)
    log(f"{arch} unprofiled decode, {MAX_NEW} tokens from one prefill: "
        f"graph_tokens_per_s={rates['decode_graph']:.2f} eager_tokens_per_s="
        f"{rates['decode_eager']:.2f} graph_over_eager="
        f"{rates['decode_graph'] / rates['decode_eager']:.2f}")
    for part, fn in (("prefill", run_prefill), ("decode_graph", run_graph),
                     ("decode_eager", run_eager)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead_in(torch)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and "spin_kernel" not in e.key]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        ours = [e for e in kernels if any(
            k in e.key for k in ("flash_attention_", "ssd_", "arima_bank",
                                 "conv_fwd<", "gn_fwd<", "decode_layer<",
                                 "un_fwd<", "sg_fwd<"))]
        ours_ms = sum(e.self_device_time_total for e in ours) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        shares[part] = busy_ms / wall_ms
        # the profiler's host cost inflates wall: the device busy time over
        # the unprofiled run's wall too
        over_unprofiled = (f" busy_over_unprofiled_wall="
                           f"{busy_ms * rates[part] / MAX_NEW / 1e3:.3f}"
                           if part in rates else "")
        log(f"{arch} profiled {part}: wall_ms={wall_ms:.2f} "
            f"device_busy_ms={busy_ms:.2f} busy_share="
            f"{busy_ms / wall_ms:.3f}{over_unprofiled} kernels="
            f"{sum(e.count for e in kernels)} port_kernels_ms={ours_ms:.3f} "
            f"port_kernels_share_of_busy={ours_ms / max(busy_ms, 1e-9):.3f} "
            f"port_kernel_launches={sum(e.count for e in ours)}")
        for e in top:
            log(f"{arch} profiled {part} kernel: ms="
                f"{e.self_device_time_total / 1e3:.3f} count={e.count} "
                f"name={e.key[:90]}")
    run_prefill()                  # caches the eager loop has not written
    check = graph_vs_eager(torch, arch, params, cfg, program, state["out"],
                           MAX_NEW)
    # every cache one step returns is the program's own buffer: the
    # program copies none back (the step runs eagerly on the buffers, then
    # the prefill's caches are loaded again)
    from repro_torch.models.transformer import decode_step
    logits, caches, n = state["out"]
    program.load(caches, logits[0].argmax(-1), n)
    _, new = decode_step(params, cfg, program.token, program.caches,
                         program.pos)
    copied = sum(a is not b for a, b in zip(_leaves(new),
                                            _leaves(program.caches)))
    if copied:
        raise AssertionError(f"{arch}: a decode step returned {copied} "
                             f"caches the program would copy back")
    # one token: one replay of the captured step traced on the card alone;
    # a Mamba layer runs K8 and K7 once in it and K6 never, every norm K9
    # once and every gated FFN K10 once (a trace that lost records is
    # taken again, up to three in all)
    program.load(caches, logits[0].argmax(-1), n)
    want = mamba_layers(cfg)
    unit = unit_calls(cfg)["serve"]
    for taken in range(1, 4):
        _, busy, kernels, table = profiled(torch, program.advance,
                                           host=False)
        calls = {k: v for k, v in port_calls(table).items()
                 if k in ("K2", "K3", "K6", "K7", "K8", "K9", "K10")}
        if calls["K7"] == calls["K8"] == want and calls["K9"] == unit[
                "K9"] and calls["K10"] == unit["K10"]:
            break
        log(f"{arch}: a profiled decode replay shows {calls} (trace "
            f"{taken})")
    dtod = sum(e.count for e in table if "Memcpy DtoD" in e.key)
    log(f"{arch} one decode token (one graph replay, card-only trace "
        f"{taken}): kernels={kernels} device_ms={busy:.3f} port_calls="
        f"{calls} K8_launches={calls['K8']} memcpy_dtod={dtod} "
        f"state_copies_returned={copied} tokens_per_s_graph="
        f"{rates['decode_graph']:.2f}")
    return {"busy_share": shares,
            "decode_tokens_per_s_graph": rates["decode_graph"],
            "decode_tokens_per_s_eager": rates["decode_eager"],
            "token_kernels": kernels, "token_device_ms": busy,
            "token_calls": calls, "token_memcpy_dtod": dtod,
            "state_copies_returned": copied, **check}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 13: the interval engine on the card's host
# ---------------------------------------------------------------------------

# the routes of IntervalVDCSimulator's static LRU serving path
INTERVAL_ROUTES = ("_run_fused", "_run_sweep", "_run_stream_interval")
# benchmarks/bench_engine.py's --full-trace settings, at 1M requests
STREAM_SEED, STREAM_USERS, STREAM_WINDOW = 12, 20_000, 131_072
STREAM_REQUESTS, STREAM_PREFIX = 1_000_000, 200_000


def record_routes(E):
    """Log, in call order, which of the interval engine's routes ran
    (``vector`` for the inherited vector paths); returns the log and a
    function that restores the methods."""
    log_, restores = [], []

    def wrap(cls, attr, label):
        inner = cls.__dict__[attr]

        def recording(self, *args, **kw):
            log_.append(label)
            return inner(self, *args, **kw)

        setattr(cls, attr, recording)
        restores.append(lambda: setattr(cls, attr, inner))

    for attr in INTERVAL_ROUTES:
        wrap(E.IntervalVDCSimulator, attr, attr.removeprefix("_run_"))
    wrap(E.VectorVDCSimulator, "run", "vector")
    return log_, lambda: [r() for r in restores]


def evict_counters(res) -> dict:
    return {"plan": res.evict_plan_calls, "trunc": res.block_truncations,
            "degen": res.degenerate_serves, "phases": res.block_phases,
            "invict": res.inblock_victims}


def interval_case(T, K, routes, name, split, profile, dev, expect: str,
                  strategy="cache_only", vector=None, **cfg_kw) -> dict:
    """Replays through ``engine="interval"`` against the port's vector
    engine on the same trace and config, in turns (vector, interval,
    interval, vector) so host drift hits both alike: requests, host
    seconds, requests/s, the interval engine's route and eviction
    counters, K1 launches.  ``vector`` (counters, seconds) stands in for
    the vector runs where an earlier phase made them; then the interval
    engine runs once.  Raises unless the counters are identical and the
    interval engine took route ``expect``."""
    train, test = split
    base = {"cache_bytes": 128 << 30, "chunk_seconds": 3600.0}
    base.update(cfg_kw)
    cfg = T.SimConfig(stream_rate_bytes_per_s=profile.bytes_per_second_stream,
                      **base).calibrate_origin(test)
    sync = _sync(dev)
    times = {"vector": [], "interval": []}
    want = None
    if vector is not None:
        want, vec_s = vector
        times["vector"].append(vec_s)
    order = ("interval",) if vector else ("vector", "interval", "interval",
                                          "vector")
    for engine in order:
        sync()
        routes.clear()
        K.reset_counts()
        t0 = time.perf_counter()
        res = T.run_strategy(strategy, test, profile.grid, cfg, train,
                             engine=engine, device=dev)
        sync()
        times[engine].append(time.perf_counter() - t0)
        check_result(res, len(test))
        if want is None:
            want = counters(res)
        elif counters(res) != want:
            raise AssertionError(f"{name}: {engine} counters {counters(res)}"
                                 f" != {want}")
        if engine == "interval":
            route, launches = "+".join(routes), K.LAUNCHES
            evict = evict_counters(res)
    its, vts = times["interval"], times["vector"]
    ratio = sum(its) / len(its) / (sum(vts) / len(vts))
    log(f"{name} {strategy} interval: requests={len(test)} seconds="
        f"{'/'.join(f'{t:.3f}' for t in its)} requests_per_s="
        f"{len(test) * len(its) / sum(its):.1f} route={route} "
        f"vector_seconds={'/'.join(f'{t:.3f}' for t in vts)} "
        f"interval_over_vector={ratio:.3f} K1_launches={launches} "
        f"evict={evict}")
    if route != expect:
        raise AssertionError(f"{name}: interval route {route}, want {expect}")
    return {"route": route, "launches": launches}


def rss_mb() -> float:
    """This process's resident set now (``/proc/self/statm``), in MiB."""
    pages = int(Path("/proc/self/statm").read_text().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**20


def sampled_peak_rss(fn):
    """``fn()`` and the largest resident set a thread saw while it ran,
    reading ``rss_mb`` every 10 ms: ``ru_maxrss`` would carry the parent's
    high-water mark across ``exec``, and the card's sandbox has no
    ``VmHWM``."""
    import threading
    peak = [rss_mb()]
    done = threading.Event()

    def sample():
        while not done.wait(0.01):
            peak[0] = max(peak[0], rss_mb())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        out = fn()
    finally:
        done.set()
        sampler.join()
    return out, max(peak[0], rss_mb())


def stream_worker(engine: str, cfg, n_requests: int, window: int,
                  conn) -> None:
    """Spawned child: the timed windowed replay of the 1M-request
    synthesized OOI stream through one engine, so that the peak resident
    set is this engine's alone.  ``cache_only`` uses no device, so the
    child asks for the CPU and holds no CUDA context."""
    import repro_torch.core as T
    from repro_torch.core import engine as E
    try:
        routes, _ = record_routes(E)
        synth = T.StreamingTraceSynthesizer(
            T.OOI_PROFILE, seed=STREAM_SEED, n_requests=n_requests,
            n_users=STREAM_USERS)
        rss0 = rss_mb()
        t0 = time.perf_counter()
        res, peak = sampled_peak_rss(lambda: T.run_strategy(
            "cache_only", synth.source(window=window), T.OOI_PROFILE.grid,
            cfg, None, engine=engine, device="cpu"))
        dt = time.perf_counter() - t0
        conn.send({"engine": engine, "requests": res.total_requests,
                   "seconds": dt, "rss_before_mb": rss0,
                   "peak_rss_mb": peak, "route": "+".join(routes),
                   "counters": counters(res),
                   "evict": evict_counters(res)})
    except Exception as e:
        conn.send({"engine": engine, "error": repr(e)})
        raise
    finally:
        conn.close()


def stream_cases(T, dev) -> None:
    """Phase 13e: the streamed replay, each engine in a spawned process,
    then the 200k-request prefix replayed materialized and windowed."""
    import multiprocessing

    synth = T.StreamingTraceSynthesizer(
        T.OOI_PROFILE, seed=STREAM_SEED, n_requests=STREAM_REQUESTS,
        n_users=STREAM_USERS)
    prefix = synth.materialize(STREAM_PREFIX)
    cfg = T.SimConfig(
        stream_rate_bytes_per_s=T.OOI_PROFILE.bytes_per_second_stream,
        cache_bytes=128 << 30, chunk_seconds=3600.0).calibrate_origin(prefix)
    ctx = multiprocessing.get_context("spawn")
    rows = {}
    for engine in ("interval", "vector"):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=stream_worker,
                        args=(engine, cfg, STREAM_REQUESTS, STREAM_WINDOW,
                              send))
        p.start()
        send.close()
        row = recv.recv()
        p.join()
        if "error" in row or p.exitcode != 0:
            raise RuntimeError(f"streamed {engine}: {row.get('error')} "
                               f"(exit {p.exitcode})")
        rows[engine] = row
        log(f"ooi stream {engine}: requests={row['requests']} "
            f"seconds={row['seconds']:.3f} requests_per_s="
            f"{row['requests'] / row['seconds']:.1f} route={row['route']} "
            f"rss_before_mb={row['rss_before_mb']:.1f} "
            f"peak_rss_mb_sampled={row['peak_rss_mb']:.1f} "
            f"evict={row['evict']}")
    if rows["interval"]["requests"] != STREAM_REQUESTS or \
            rows["interval"]["counters"] != rows["vector"]["counters"]:
        raise AssertionError("streamed replay: interval and vector disagree")
    if not rows["interval"]["route"].startswith("stream_interval"):
        raise AssertionError(f"streamed interval took {rows['interval']}")
    out = {}
    for how, reqs in (("materialized", prefix), ("windowed",
                      T.StreamingRequestSource.from_requests(
                          prefix, window=STREAM_WINDOW // 8))):
        t0 = time.perf_counter()
        res = T.run_strategy("cache_only", reqs, T.OOI_PROFILE.grid, cfg,
                             None, engine="interval", device=dev)
        out[how] = counters(res)
        log(f"ooi stream prefix {how} interval: requests={STREAM_PREFIX} "
            f"seconds={time.perf_counter() - t0:.3f}")
    if out["materialized"] != out["windowed"]:
        raise AssertionError("prefix: materialized != windowed")


def interval_phase(T, K, dev, reuse: dict) -> int:
    """Phase 13; returns K1's launches in the ``hpm`` interval replay."""
    from repro_torch.core import engine as E

    routes, restore = record_routes(E)
    ooi, grid = reuse["ooi"], T.OOI_PROFILE
    try:
        log("== phase 13a: the interval engine on OOI, scale 1.0")
        interval_case(T, K, routes, "ooi", ooi, grid, dev, "fused")

        log("== phase 13b: thrash, 8 GB per DTN")
        gage = T.make_trace("gage", seed=0, scale=1.0)
        cut = int(len(gage) * 0.3)
        interval_case(T, K, routes, "ooi", ooi, grid, dev, "fused",
                      cache_bytes=8 << 30)
        interval_case(T, K, routes, "gage", (gage[:cut], gage[cut:]),
                      T.GAGE_PROFILE, dev, "fused", cache_bytes=8 << 30)

        log("== phase 13c: fine chunking")
        half = T.make_trace("ooi", seed=0, scale=0.5)
        cut = int(len(half) * 0.3)
        interval_case(T, K, routes, "ooi", ooi, grid, dev, "fused",
                      chunk_seconds=300.0)
        interval_case(T, K, routes, "ooi_0.5", (half[:cut], half[cut:]),
                      grid, dev, "sweep", chunk_seconds=60.0)

        log("== phase 13d: hpm on ooi_arima through the interval engine")
        profile, train, test = reuse["ooi_arima"]
        # phase 4 is the vector run of the same trace and config
        hpm = interval_case(T, K, routes, "ooi_arima", (train, test),
                            profile, dev, "vector", strategy="hpm",
                            vector=reuse["ooi_arima_hpm"])
        if hpm["launches"] == 0:
            raise AssertionError(f"ooi_arima hpm interval: {hpm}")
    finally:
        restore()

    log("== phase 13e: streamed OOI, 1M requests (bench_engine settings)")
    stream_cases(T, dev)
    return hpm["launches"]


# ---------------------------------------------------------------------------
# phases 14-17: the GRU predictor (K4), the K2/K3 generic routes and the
# reduced configs served on the card
# ---------------------------------------------------------------------------

GRU_BUCKETS = (4, 8, 16, 32, 60)
GRU_STEPS, GRU_LR = 150, 0.03
GRU_HISTORIES = range(40, 80)     # beyond_rnn_predictor.run's 40 histories


def gru_regimes(np) -> dict:
    """``benchmarks/beyond_rnn_predictor.py:15-24``'s three regimes from
    ``default_rng(0)``, 80 gaps each: near-periodic (cron script),
    drifting (adaptive poller), bursty (human)."""
    rng = np.random.default_rng(0)
    n = 80
    return {
        "periodic": 3600 + rng.normal(0, 180, n),
        "drifting": 600 + 8 * np.arange(n) + rng.normal(0, 40, n),
        "bursty": rng.choice([60.0, 300.0, 3600.0], n,
                             p=[0.5, 0.3, 0.2]) * rng.lognormal(0, 0.2, n),
    }


def gru_work(rows: int, n: int) -> tuple[int, int]:
    """(bytes, float32 operations) one K4 launch needs for rows x n.

    Bytes: each row and the 517 initial parameters read once, each forecast
    written once.  Operations per row, each multiply, add, division, square
    root, exp and tanh one (the kernel contracts nothing: -fmad=false):
    normalise (~6n); per Adam step, per time step 1,104 forward (12 units x
    92: three 12-term products and sums, two sigmoids, a tanh, the update),
    26 for the prediction and its adjoint and 2,089 back (12 units x 174,
    and gbo), then 14 per parameter of Adam; a last forward pass."""
    per_step = n * (1104 + 26 + 2089) + 14 * 517
    per_row = 6 * n + GRU_STEPS * per_step + n * 1104 + 24
    return rows * n * 4 + 517 * 4 + rows * 4, rows * per_row


def sm_clock_max_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


GRU_PROBES = ("add", "mul", "shfl", "smem_broadcast", "sigmoid",
              "tanhf_mul_large", "tanhf_mul_small")


def gru_latency_probe(torch, nvcc, flags, dev) -> dict[str, float]:
    """SM cycles per operation of dependent chains on one warp of the
    card (``csrc/gru_latency_probe.cu``, built with K4's ``flags``), one
    entry per :data:`GRU_PROBES` name: an add, a multiply, a
    ``__shfl_sync``, the shared-memory broadcast (store, ``__syncwarp``,
    128-bit load), the fit's sigmoid, and ``tanhf`` followed by a multiply
    at ``|x| ~ 3`` and at ``|x| < 0.5``."""
    fn = nvcc.load("gru_latency_probe", flags).gru_latency_probe_launch
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    consts = torch.tensor([1e-7, 1.0000001, 3.0, 0.9], dtype=torch.float32,
                          device=dev)
    cycles = torch.zeros(len(GRU_PROBES), dtype=torch.float32, device=dev)
    sink = torch.empty(32, dtype=torch.float32, device=dev)
    err = fn(consts.data_ptr(), cycles.data_ptr(), sink.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    nvcc.check_launch("gru_latency_probe", err)
    lat = dict(zip(GRU_PROBES, cycles.tolist()))
    # each finite and at least one cycle; an add or a multiply takes a few
    if not all(1.0 <= c < 1000.0 for c in lat.values()) or \
            not (lat["add"] < 16 and lat["mul"] < 16):
        raise AssertionError(f"K4 latency probe out of range: {lat}")
    return lat


def gru_chain_cycles(lat: dict) -> tuple[float, float]:
    """Fewest SM cycles one forward and one reverse GRU step's critical
    path can take (``csrc/gru_fit.cu``'s header), from the latencies
    :func:`gru_latency_probe` measured: a broadcast of 12 values (the
    faster of one shuffle and one shared-memory round trip), a 12-term sum
    (a multiply, then the tree's four dependent adds), the sigmoid and
    tanhf (the faster of its two ranges) as the fit computes them.

    Forward: broadcast h, Wr . h, + ur x, + br, sigmoid, r * h, broadcast,
    Wc . (r h), + uc x, + bc, tanhf, z * c, + (1 - z) h.  Reverse: gh +=
    gp wo, dc = gh z, dac, broadcast, Wc^T . dac, dr = drh h, dar,
    broadcast, Wr^T . dar, dh +=."""
    add, mul = lat["add"], lat["mul"]
    bcast = min(lat["shfl"], lat["smem_broadcast"])
    dot = mul + 4 * add
    tanh = min(lat["tanhf_mul_large"], lat["tanhf_mul_small"]) - mul
    fwd = (bcast + dot + 2 * add + lat["sigmoid"] + mul
           + bcast + dot + 2 * add + tanh + mul + add)
    rev = add + 2 * mul + bcast + dot + 2 * mul + bcast + dot + add
    return fwd, rev


def phase_k4(torch, np, K4, T_rnn, nvcc, dev) -> dict:
    """Phase 14: K4 against its plain version on the card, bitwise, at
    every bucket: the three regimes' 40 histories each (the last n gaps of
    a history; a history shorter than n gives the regime's first n gaps),
    120 rows in one call on each side; times at n = 60."""
    log("== phase 14: K4 (GRU fit) vs plain, 3 regimes x 40 histories "
        "per bucket")
    regimes = gru_regimes(np)
    p0 = T_rnn.init_params(0).to(dev)
    rec = {"max_abs_err": 0.0, "bitwise_rows": 0, "rows": 0}
    for n in GRU_BUCKETS:
        rows = np.stack([g[:max(i, n)][-n:] for g in regimes.values()
                         for i in GRU_HISTORIES]).astype(np.float32)
        y = torch.from_numpy(rows).to(dev)
        got = K4.gru_fit(y, p0, GRU_STEPS, GRU_LR)
        out = {}

        def plain(y=y):
            out["want"] = K4.gru_fit_plain(y, p0, GRU_STEPS, GRU_LR)

        plain_ms = cuda_ms(plain, reps=1, warmup=False)
        want = out["want"]
        bits = int((got.view(torch.int32) == want.view(torch.int32)).sum())
        err = float((got - want).abs().max())
        batch_ms = cuda_ms(lambda: K4.gru_fit(y, p0, GRU_STEPS, GRU_LR),
                           reps=3)
        log(f"K4 n={n}: rows={len(rows)} bitwise_equal_rows={bits}/"
            f"{len(rows)} max_abs_err={err:.6g} plain_ms={plain_ms:.1f} "
            f"batch_kernel_ms={batch_ms:.4f} "
            f"forecasts_finite={bool(torch.isfinite(got).all())}")
        if bits != len(rows) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K4 n={n}: {len(rows) - bits} rows differ "
                                 f"from the plain version (or not finite)")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["bitwise_rows"] += bits
        rec["rows"] += len(rows)
        if n == 60:
            rec["batch_ms"], rec["batch_plain_ms"] = batch_ms, plain_ms
            y1 = y[-1:].contiguous()         # the longest history
            rec["ms"] = cuda_ms(lambda: K4.gru_fit(y1, p0, GRU_STEPS,
                                                   GRU_LR), reps=10)

            def plain_one():
                out["one"] = K4.gru_fit_plain(y1, p0, GRU_STEPS, GRU_LR)

            rec["plain_ms"] = cuda_ms(plain_one, reps=1, warmup=False)
            if not torch.equal(out["one"].view(torch.int32),
                               got[-1:].view(torch.int32)):
                raise AssertionError("K4 n=60: one row alone differs from "
                                     "its row in the batch")
            model = T_rnn.GRUPredictor(device=dev)
            series = rows[-1]
            model.forecast_next(series)
            t0 = time.perf_counter()
            for _ in range(10):
                model.forecast_next(series)
            rec["forecast_next_ms"] = (time.perf_counter() - t0) / 10 * 1e3
    rec["bound_ms"], rec["bound_by"] = bound_ms([gru_work(1, 60)])
    # the chain-latency bound: steps x (forward + reverse) steps' paths and
    # the last forward pass, at the card's maximum SM clock
    lat = gru_latency_probe(torch, nvcc, K4.NVCC_FLAGS, dev)
    fwd, rev = gru_chain_cycles(lat)
    mhz = sm_clock_max_mhz()
    cycles = GRU_STEPS * 60 * (fwd + rev) + 60 * fwd
    rec["chain_bound_ms"] = cycles / (mhz * 1e3)
    rec["sm_clock_max_mhz"] = mhz
    log("K4 latency probe (SM cycles per dependent operation): " +
        " ".join(f"{k}={v:.2f}" for k, v in lat.items()))
    log(f"K4 at n=60, one row (the predictor's launch): kernel_ms="
        f"{rec['ms']:.4f} plain_ms={rec['plain_ms']:.1f} "
        f"forecast_next_ms={rec['forecast_next_ms']:.4f} bound_ms="
        f"{rec['bound_ms']:.6f} ({rec['bound_by']}) kernel_over_bound="
        f"{rec['ms'] / rec['bound_ms']:.0f} chain_forward_step_cycles="
        f"{fwd:.1f} chain_reverse_step_cycles={rev:.1f} "
        f"sm_clock_max_mhz={mhz:.0f} chain_bound_ms="
        f"{rec['chain_bound_ms']:.4f} kernel_over_chain_bound="
        f"{rec['ms'] / rec['chain_bound_ms']:.3f} batch_of_120_kernel_ms="
        f"{rec['batch_ms']:.4f} library_ms=null")
    return rec


def phase_gru_vs_arima(torch, np, K, K4, T_arima, T_rnn, dev) -> dict:
    """Phase 15 (main path of K4): ``benchmarks/beyond_rnn_predictor.run``
    through the port, 3 regimes x 40 next-request-time forecasts each
    through ``predict_next_timestamp_rnn`` (K4) and
    ``predict_next_timestamp`` (K1).  Errors and times are information;
    the run fails only on a non-finite forecast or a kernel never
    launched."""
    log("== phase 15: GRU vs ARIMA next-request time through the port "
        "(beyond_rnn_predictor.run)")
    arima = T_arima.ARIMA(device=dev)
    gru = T_rnn.GRUPredictor(device=dev)
    torch.cuda.synchronize()
    K.reset_counts()                          # counts of this run only
    K4.reset_counts()
    for name, gaps in gru_regimes(np).items():
        ts = np.concatenate([[0.0], np.cumsum(gaps)])
        errs = {"arima": [], "gru": []}
        secs = {"arima": 0.0, "gru": 0.0}
        for i in GRU_HISTORIES:
            hist = ts[: i + 1]
            true_next = ts[i + 1]
            span = true_next - ts[i]
            t0 = time.perf_counter()
            pa = T_arima.predict_next_timestamp(hist, arima)
            t1 = time.perf_counter()
            pg = T_rnn.predict_next_timestamp_rnn(hist, gru)
            t2 = time.perf_counter()
            secs["arima"] += t1 - t0
            secs["gru"] += t2 - t1
            errs["arima"].append(abs(pa - true_next) / max(span, 1.0))
            errs["gru"].append(abs(pg - true_next) / max(span, 1.0))
        k = len(GRU_HISTORIES)
        log(f"rnn_vs_arima_{name}: forecasts={k} "
            f"arima_relerr={np.mean(errs['arima']):.4f} "
            f"gru_relerr={np.mean(errs['gru']):.4f} "
            f"arima_us_per_forecast={secs['arima'] / k * 1e6:.1f} "
            f"gru_us_per_forecast={secs['gru'] / k * 1e6:.1f}")
        if not np.isfinite(errs["arima"] + errs["gru"]).all():
            raise AssertionError(f"{name}: a non-finite forecast")
    launches = {"K1": K.LAUNCHES, "K4": K4.LAUNCHES}
    log(f"GRU vs ARIMA launches: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"GRU vs ARIMA: a kernel never ran {launches}")
    return launches


# b, s, hq, hkv, d, window, dtype name, tol: the reduced configs' attention
# at S=2048 (yi-6b 4/2 heads of 16, starcoder2-7b 6/2 of 12, stablelm-12b
# 4/2 of 20 in float32, gemma3-27b's local layers 4/2 of 16, window 32),
# head dim 8 (paligemma-3b's 256 runs on the fast routes, phase 8)
GENERIC_ATTN_SHAPES = [
    (1, 2048, 4, 2, 16, None, "bfloat16", 2e-2),
    (1, 2048, 6, 2, 12, None, "bfloat16", 2e-2),
    (1, 2048, 4, 2, 20, None, "float32", 2e-5),
    (1, 2048, 4, 2, 16, 32, "bfloat16", 2e-2),
    (1, 512, 4, 1, 8, None, "float32", 2e-5),
]

# bt, s, h, p, g, n, dtype name, tol: mamba2-1.3b-reduced's scan (8 heads
# of 16, N=16) at S=2048 in both types, and (N, P) = (16, 64)
GENERIC_SSD_SHAPES = [
    (1, 2048, 8, 16, 1, 16, "bfloat16", 5e-2),
    (1, 2048, 8, 16, 1, 16, "float32", 1e-3),
    (1, 2048, 8, 64, 1, 16, "bfloat16", 5e-2),
]


def phase_generic_routes(torch, K2, K3, dev) -> tuple[list, list]:
    """Phase 16: K2 and K3 on their generic routes against the plain
    versions, with times and bounds; each case raises unless its launch
    took the route ``route()`` names, and that is the generic route for
    every shape here."""
    log("== phase 16: K2 and K3 generic routes vs plain")
    gen = torch.Generator(device=dev).manual_seed(16)
    k2 = [k2_case(torch, K2, dev, gen, shape) for shape in GENERIC_ATTN_SHAPES]
    k3 = [k3_case(torch, K3, dev, gen, shape) for shape in GENERIC_SSD_SHAPES]
    if any(c["route"] != "generic" for c in k2 + k3):
        raise AssertionError("phase 16: route() names a fast route for a "
                             "generic case")
    return k2, k3


REDUCED_ARCHS = ("yi-6b", "starcoder2-7b", "stablelm-12b", "gemma3-27b",
                 "mamba2-1.3b", "deepseek-v3-671b", "arctic-480b",
                 "jamba-1.5-large-398b", "musicgen-large", "paligemma-3b")


def reduced_serve_phase(torch, counts: dict, dev) -> dict:
    """Phase 17: ``launch/serve.py --reduced --device cuda`` for each
    reduced config (12 requests, 32-token prompts, 8 new tokens): K2
    launches where the config has GQA attention, K3 where it has Mamba
    layers (none for deepseek-v3's MLA), every one on the generic route;
    then one 256-token prefill through the kernels against the same prefill
    through their plain versions.  Returns each kernel's launches per
    config."""
    from repro_torch.launch import serve as L

    log("== phase 17: reduced configs served on the card "
        "(launch/serve.py --reduced --device cuda)")
    out = {}
    for arch in REDUCED_ARCHS:
        for m in counts.values():
            m.reset_counts()                 # counts of this run only
        t0 = time.perf_counter()
        engine = L.main(["--arch", arch, "--reduced", "--device", "cuda"])
        torch.cuda.synchronize()
        mixers = {m for m, _ in engine.cfg.prelude + engine.cfg.pattern}
        expect = {"K2": any(m.startswith("attn") for m in mixers),
                  "K3": "mamba" in mixers}
        got = {key: (counts[key].LAUNCHES,
                     counts[key].ROUTE_LAUNCHES["generic"])
               for key in expect}
        log(f"{arch}-reduced: seconds={time.perf_counter() - t0:.2f} "
            f"requests={engine.stats['total']} prewarmed="
            f"{engine.stats['prefetched_prefills']} launches_and_generic="
            f"{got} K1_launches={counts['K1'].LAUNCHES}")
        for key, runs in expect.items():
            launches, generic = got[key]
            if (launches > 0) != runs or generic != launches:
                raise AssertionError(f"{arch}-reduced: {key} launched "
                                     f"{launches} times, {generic} on the "
                                     f"generic route")
        mods = [counts[key] for key, runs in expect.items() if runs]
        if mods:
            check_prefill_pair(f"{arch}-reduced", *prefill_pair(
                torch, engine.cfg, engine.params, mods, dev))
        out[arch] = {key: got[key][0] for key in expect}
    return out


# ---------------------------------------------------------------------------
# phase 18: training on the card
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 6


def rel_l2(torch, got, want) -> float:
    """Relative L2 distance of two trees of tensors, in float64 on the
    host."""
    import torch.utils._pytree as pytree
    g, w = (torch.cat([t.double().cpu().flatten()
                       for t in pytree.tree_leaves(tree)])
            for tree in (got, want))
    return float((g - w).norm() / w.norm())


def train_card_vs_cpu(torch, dev) -> None:
    """18a: one float32 ``make_train_step`` step of reduced yi-6b,
    mamba2-1.3b, deepseek-v3 (MLA, MoE, MTP, aux loss) and jamba (Mamba,
    attention, MoE) on the card and on the CPU, same parameters and batch:
    loss within rtol 1e-4, the first moment within 1e-3 relative L2."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import _to, init_params
    from repro_torch.train.loop import (TrainConfig, batch_to_device,
                                        make_train_step)
    from repro_torch.train.optimizer import adamw_init

    log("== phase 18a: one train step on the card against the CPU "
        "(reduced, float32)")
    for arch in ("yi-6b", "mamba2-1.3b", "deepseek-v3-671b",
                 "jamba-1.5-large-398b"):
        cfg = dataclasses.replace(get_reduced_config(arch),
                                  dtype=torch.float32)
        params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        src = SyntheticLM(vocab=cfg.vocab, seq_len=128, batch=4)
        batch = src.batch_from_shard(src.load_shard(0))
        tcfg = TrainConfig()
        step = make_train_step(cfg, tcfg)
        _, cpu_opt, cpu_m = step(params, adamw_init(params, tcfg.optimizer),
                                 batch_to_device(batch, "cpu"))
        on_card = _to(params, dev)
        _, dev_opt, dev_m = step(on_card, adamw_init(on_card, tcfg.optimizer),
                                 batch_to_device(batch, dev))
        loss_rel = abs(float(dev_m["loss"]) / float(cpu_m["loss"]) - 1)
        m_rel = rel_l2(torch, dev_opt["m"], cpu_opt["m"])
        log(f"{arch}-reduced f32: loss card={float(dev_m['loss']):.7f} "
            f"cpu={float(cpu_m['loss']):.7f} rel={loss_rel:.3g} "
            f"aux card={float(dev_m['aux']):.7f} "
            f"cpu={float(cpu_m['aux']):.7f} "
            f"grad_norm card={float(dev_m['grad_norm']):.7f} "
            f"cpu={float(cpu_m['grad_norm']):.7f} m_rel_l2={m_rel:.3g}")
        if not (loss_rel <= 1e-4 and m_rel <= 1e-3):
            raise AssertionError(f"{arch}: the card's train step disagrees "
                                 f"with the CPU's")


# In a long run a card-only trace has lost the records of its first ~25
# kernels, in every trace of one train step (phase 18b, chip run 3 of PR
# 27; alone, the same step traced whole).  A trace opens with spin kernels
# that take such a loss; they are left out of its table.
LEAD_IN_SPINS = 64


def lead_in(torch) -> None:
    """Spin kernels (``torch.cuda._sleep``: one of ~1 ms, then
    ``LEAD_IN_SPINS`` short ones), waited for."""
    torch.cuda._sleep(2_000_000)
    for _ in range(LEAD_IN_SPINS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def profiled(torch, fn, host: bool) -> tuple[float, float, int, list]:
    """(wall ms, device busy ms, kernels, kernel table) of one call of
    ``fn`` under ``torch.profiler``, tracing the card only or the host's
    operators too (whose own host cost inflates wall); the trace opens
    and closes ``TRACE_PAD_S`` away from the call, after :func:`lead_in`,
    whose kernels the table leaves out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(TRACE_PAD_S)
        lead_in(torch)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(TRACE_PAD_S)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.key]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return wall_ms, busy_ms, sum(e.count for e in kernels), kernels


def step_profile(torch, fn, label: str, reps: int = 3, table_ok=None,
                 traces: int = 3) -> dict:
    """One step ``fn`` on the card: the median wall ms of ``reps``
    unprofiled calls; device busy ms, busy share (busy over the wall of the
    same call) and kernels of one call profiled tracing the card only
    (CUPTI adds little host cost, unlike the host operator trace), with
    the card-only kernel table; then one call tracing the host too, whose
    largest kernels are logged.  The busy share is None where the
    card-only trace shows no device time.  With ``table_ok``, a card-only
    trace whose kernel table it refuses (records missing) is taken again,
    up to ``traces`` in all, and every number returned is the last
    trace's; ``traces`` in the result counts them."""
    import statistics
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    plain_ms = statistics.median(walls)
    for taken in range(1, traces + 1):
        wall, busy, n, table = profiled(torch, fn, host=False)
        if table_ok is None or table_ok(table):
            break
        log(f"{label}: card-only trace {taken} refused (kernels={n})")
    share = busy / wall if busy > 0 else None
    log(f"{label}: unprofiled step wall_ms={plain_ms:.2f} (median of "
        f"{reps}); card-only profiled step wall_ms={wall:.2f} "
        f"device_busy_ms={busy:.2f} busy_share="
        f"{'not measured' if share is None else f'{share:.3f}'} kernels={n}"
        f" (trace {taken})")
    hwall, hbusy, hn, kernels = profiled(torch, fn, host=True)
    log(f"{label}: host-and-card profiled step wall_ms={hwall:.2f} "
        f"device_busy_ms={hbusy:.2f} busy_share={hbusy / hwall:.3f} "
        f"kernels={hn}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  profiled step kernel: ms={e.self_device_time_total / 1e3:.3f}"
            f" count={e.count} name={e.key[:90]}")
    return {"wall_ms": plain_ms, "busy_ms": busy, "busy_share": share,
            "kernels": n, "traces": taken, "table": table}


# what the device time of a profiled train step is split into, by kernel
# name: K5 (AdamW), K2 forward and backward, K3 forward, K3 backward, the
# Mamba block's K6 (conv) and K7 (gated norm) forward and backward and K8
# (decode step), the unit's K9 (residual add + RMSNorm) and K10 (SwiGLU
# gate) forward and backward, matrix products (cuBLAS); then the plain attention's own
# kernels (its softmax, the softmax's backward, the `where` of its mask),
# the cross-entropy's (the gold logit's gather and its scatter backward,
# the max, exp and log of its logsumexp), copies and casts (the float32
# casts of the plain attention's logits among them, and every other
# cast); the rest are the other elementwise and reduction kernels
def op_class(name: str) -> str:
    low = name.lower()
    if "adamw_" in name:
        return "K5"
    if "flash_bwd_" in name:
        return "K2 backward"
    if "flash_attention_" in name:
        return "K2 forward"
    if "::bwd_" in name:
        return "K3 backward"
    if "ssd_" in name:
        return "K3 forward"
    for marks, cls in ((("conv_fwd<",), "K6 forward"),
                       (("conv_bwd<", "conv_reduce<"), "K6 backward"),
                       (("gn_fwd<",), "K7 forward"),
                       (("gn_bwd<", "gn_reduce("), "K7 backward"),
                       (("decode_layer<",), "K8"),
                       (("un_fwd<",), "K9 forward"),
                       (("un_bwd<", "un_reduce("), "K9 backward"),
                       (("sg_fwd<",), "K10 forward"),
                       (("sg_bwd<",), "K10 backward")):
        if any(m in name for m in marks):
            return cls
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "GEMMs"
    if "softmax" in low and "logsoftmax" not in low:
        return ("attention softmax backward" if "backward" in low
                else "attention softmax")
    if "where_kernel" in low:
        return "attention where"
    if any(k in low for k in ("gather", "scatter", "log_kernel", "exp_kernel",
                              "maxops", "logsoftmax", "nll_loss")):
        return "cross-entropy"
    if "copy_kernel" in low:
        return "copies and casts"
    return "other"


# kernels that each call of a wrapper launches once: K2's forward (one
# kernel on every route) and its backward's dQ pass; K3's, by route (its
# forward's output pass or generic scan, its backward's gradient pass or
# generic backward); K5's three kernels, each once a call; K6's and K7's
# forward and backward (one call without a mesh group); K8; K9's and K10's
# forward and backward
ONCE_PER_CALL = {"K2": ("flash_attention_",),
                 "K2_backward": ("flash_bwd_dq_",),
                 "K3": ("::ssd_output_", "::ssd_scan_generic"),
                 "K3_backward": ("::bwd_grad_", "::bwd_generic"),
                 "K5": ("adamw_norm", "adamw_finish", "adamw_apply"),
                 "K6": ("conv_fwd<",), "K6_backward": ("conv_bwd<",),
                 "K7": ("gn_fwd<",), "K7_backward": ("gn_bwd<",),
                 "K8": ("decode_layer<",),
                 "K9": ("un_fwd<",), "K9_backward": ("un_bwd<",),
                 "K10": ("sg_fwd<",), "K10_backward": ("sg_bwd<",)}


def port_calls(table) -> dict:
    """K2, K3, K6, K7, K9 and K10 forward and backward calls, K8 calls,
    and K5's kernels, a profiled kernel table holds."""
    return {k: sum(e.count for e in table if any(m in e.key for m in marks))
            for k, marks in ONCE_PER_CALL.items()}


def op_split(torch, label: str, table, adamw_ms: float) -> dict:
    """Device ms of a profiled step by op class (:func:`op_class`), the
    eight largest other kernels by name, and the in-place AdamW update
    (``adamw_update_``, one K5 call) timed alone."""
    by = {}
    for e in table:
        key = op_class(e.key)
        by[key] = by.get(key, 0.0) + e.self_device_time_total / 1e3
    others = sorted((e for e in table if op_class(e.key) == "other"),
                    key=lambda e: -e.self_device_time_total)[:8]
    log(f"{label}: device ms by op: " + " ".join(
        f"{k.replace(' ', '_')}={v:.2f}" for k, v in sorted(by.items()))
        + f" adamw_alone_ms={adamw_ms:.2f}")
    for e in others:
        log(f"  other kernel: ms={e.self_device_time_total / 1e3:.3f} "
            f"count={e.count} name={e.key[:90]}")
    return {**by, "adamw_alone_ms": adamw_ms,
            "largest_other": [(e.key[:90], e.self_device_time_total / 1e3,
                               e.count) for e in others]}


def mamba_layers(cfg) -> int:
    return sum(m == "mamba" for m, _ in cfg.prelude) + \
        cfg.n_units * sum(m == "mamba" for m, _ in cfg.pattern)


def unit_calls(cfg) -> dict:
    """K9 and K10 calls of one forward: K9 once a norm (a layer's one or
    two, the final norm, the MTP layer's and its norm), K10 once a gated
    dense FFN; the units' counts apart (the remat recomputes them), and
    ``serve``: a prefill's or a decode step's (no MTP layer)."""
    def norms(specs):
        return sum(1 + (ffn != "none") for _, ffn in specs)

    def gates(specs):
        return sum(ffn == "dense" and cfg.gated_mlp for _, ffn in specs)
    mtp = (cfg.pattern[-1],) if cfg.mtp else ()
    units = {"K9": cfg.n_units * norms(cfg.pattern),
             "K10": cfg.n_units * gates(cfg.pattern)}
    # a prefill or a decode step: no MTP layer
    serve = {"K9": units["K9"] + norms(cfg.prelude) + 1,
             "K10": units["K10"] + gates(cfg.prelude)}
    return {"K9_units": units["K9"],
            "K9_rest": serve["K9"] - units["K9"] + norms(mtp) + len(mtp),
            "K10_units": units["K10"],
            "K10_rest": serve["K10"] - units["K10"] + gates(mtp),
            "serve": serve}


def step_calls(cfg, mesh: bool = False) -> dict:
    """Wrapper calls of one train step: K2 forward once an attention layer
    and K3, K6 and K7 forward once a Mamba layer, K9 once a norm and K10
    once a gated FFN (each in the units twice with the remat recompute),
    each one's backward once, K5 once (three kernels; four on a mesh), no
    K8."""
    n, a = mamba_layers(cfg), attn_layers(cfg)
    passes = 1 if cfg.remat == "none" else 2
    fwd = n * passes
    u = unit_calls(cfg)
    return {"K2": a * passes, "K2_backward": a, "K3": fwd, "K3_backward": n,
            "K5": 4 if mesh else 3, "K6": fwd, "K6_backward": n, "K7": fwd,
            "K7_backward": n, "K8": 0,
            "K9": u["K9_units"] * passes + u["K9_rest"],
            "K9_backward": u["K9_units"] + u["K9_rest"],
            "K10": u["K10_units"] * passes + u["K10_rest"],
            "K10_backward": u["K10_units"] + u["K10_rest"]}


def train_cell(torch, cfg, dev, counts: dict, label: str, tcfg=None,
               eager: bool = True) -> dict:
    """18b/18c/18e: ``train_loop`` (bf16, ``tcfg`` or the default
    ``TrainConfig``, remat per unit) on ``SyntheticLM`` through
    ``PrefetchingLoader``, TRAIN_BATCH x TRAIN_SEQ tokens a step for
    TRAIN_STEPS steps: an eager warm-up step, then one step captured in a
    CUDA graph and replayed.  Gates: every loss and grad norm finite, no
    step skipped, the last loss below the first, no K8 launch, and K2's,
    K3's, K6's and K7's forward and backward and K5's wrappers called
    exactly the step's count twice (the warm-up and the capture; replays
    call no wrapper).  Then, in the same run, eager ``make_train_step``
    steps (with ``eager``; a functional step holds a second copy of the
    state) and replays of a captured ``TrainProgram``, the first replay
    bit for bit (loss, grad norm, parameters and moments) the eager step
    from the same state (with ``eager``): wall, tokens/s, 6·N·T share,
    busy share, kernels and peak memory of each, the device time by op with the
    in-place update timed alone (on a copy of the state with ``eager``,
    else on the state itself, last), and (Mamba) one layer's SSD through
    K3 and through autograd of the plain ``ssd_chunked``.  A gate reads
    the profiled replay's kernel table: it ran K2's, K3's, K6's and K7's
    forward and backward and K5's three kernels the step's count of
    times.  The
    launches
    reported are those executed: the warm-up's and each replay's,
    TRAIN_STEPS steps of the step's count."""
    import gc
    import statistics

    import torch.utils._pytree as pytree

    from repro_torch.data.pipeline import PrefetchingLoader, SyntheticLM
    from repro_torch.models.transformer import param_count
    from repro_torch.train.loop import (TrainConfig, TrainProgram,
                                        batch_to_device, make_train_step,
                                        train_loop)
    from repro_torch.train.optimizer import adamw_update_

    K3, K5 = counts["K3"], counts["K5"]
    tcfg = dataclasses.replace(tcfg or TrainConfig(), log_every=1)
    loader = PrefetchingLoader(
        SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                    n_shards=512), n_steps=TRAIN_STEPS + 2)
    history, held = [], []

    def log_fn(s, m):
        history.append(m)
        held.append(held_gib(torch))

    for mod in counts.values():
        mod.reset_counts()                   # counts of this run only
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        params, opt, _ = train_loop(
            cfg, tcfg, iter(loader), TRAIN_STEPS, device=dev, log_fn=log_fn)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
        stats = loader.stats
        batch = batch_to_device(next(loader), dev)
    finally:
        loader.close()
    K6, K7, K8 = counts["K6"], counts["K7"], counts["K8"]
    wrapper_calls = {"K2": sum(counts["K2"].ROUTE_LAUNCHES.values()),
                     "K2_backward": counts["K2"].BWD_LAUNCHES,
                     "K3": K3.LAUNCHES, "K3_backward": K3.BWD_LAUNCHES,
                     "K5": K5.LAUNCHES, "K6": K6.LAUNCHES,
                     "K6_backward": K6.BWD_LAUNCHES, "K7": K7.LAUNCHES,
                     "K7_backward": K7.BWD_LAUNCHES, "K8": K8.LAUNCHES}
    for k in ("K9", "K10"):
        wrapper_calls[k] = counts[k].LAUNCHES
        wrapper_calls[f"{k}_backward"] = counts[k].BWD_LAUNCHES
    per_step = step_calls(cfg)
    n = param_count(params)
    state_bytes = sum(x.numel() * x.element_size()
                      for x in pytree.tree_leaves((params, opt)))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    times = [m["step_time"] for m in history]
    med = statistics.median(times[1:])
    share = 6 * n * tokens / med / BF16_FLOP_PER_S
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"{label}: params={n} dtype={cfg.dtype} remat={cfg.remat} "
        f"n_layers={cfg.n_layers} moments={tcfg.optimizer.moment_dtype} "
        f"tokens_per_step={tokens} steps={len(history)} "
        f"seconds_with_init={seconds:.2f}")
    log(f"{label}: loss={[round(m['loss'], 5) for m in history]}")
    log(f"{label}: grad_norm={[round(m['grad_norm'], 5) for m in history]}")
    log(f"{label}: graph step_s={[round(t, 4) for t in times]} (step 1: "
        f"eager warm-up and capture) median_step_s_2_to_{TRAIN_STEPS}="
        f"{med:.4f} tokens_per_s={tokens / med:.1f} "
        f"six_n_t_share_of_989_tflops={share:.4f}")
    log(f"{label}: peak_gib={peak / 2**30:.2f} state_gib="
        f"{state_bytes / 2**30:.2f} (parameters and optimizer state) "
        f"peak_reserved_gib={peak_reserved / 2**30:.2f} card_gib="
        f"{total / 2**30:.2f} peak_share={peak / total:.3f} held_gib "
        f"steps 2-{TRAIN_STEPS}={max(held[1:]):.2f} (allocated outside the "
        f"graph's pool plus the pool's segments) "
        f"pipeline_stats={stats} opt_step={int(opt['step'])} wrapper_calls="
        f"{wrapper_calls} (per step {per_step}; in the warm-up and the "
        f"capture, the {TRAIN_STEPS - 1} replays call no wrapper)")
    bad = [m for m in history if not (math.isfinite(m["loss"])
                                      and math.isfinite(m["grad_norm"]))]
    if bad or len(history) != TRAIN_STEPS:
        raise AssertionError(f"{label}: non-finite loss or grad norm")
    if int(opt["step"]) != TRAIN_STEPS:
        raise AssertionError(f"{label}: {TRAIN_STEPS - int(opt['step'])} "
                             f"steps skipped")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError(f"{label}: the loss did not fall")
    if wrapper_calls != {k: 2 * v for k, v in per_step.items()}:
        raise AssertionError(f"{label}: wrapper calls {wrapper_calls}, "
                             f"want twice {per_step}")

    # eager steps in the same run, then replays of a captured program
    step = make_train_step(cfg, tcfg)
    state = {}
    eager_res = None
    if eager:
        def eager_step():
            state.pop("out", None)
            state["out"] = step(params, opt, batch)

        eager_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eager_step()
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated()
        eager_res = step_profile(torch, eager_step, f"{label} eager")
        state.clear()
    gc.collect()                # train_loop's program and its graph pool
    torch.cuda.empty_cache()
    program = TrainProgram(step, params, opt, batch)
    program.step(batch)                     # warm-up and capture
    replay_vs_eager = None
    if eager:
        # one replay against the eager step from the same state: the
        # functional step on the program's tensors, then the replay
        ref = step(program.params, program.opt_state, batch)
        got = program.step(batch)
        replay_vs_eager = all(
            float(ref[2][k]) == float(got[k]) for k in ("loss", "grad_norm")
        ) and all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves((ref[0], ref[1])),
            pytree.tree_leaves((program.params, program.opt_state))))
        del ref
        log(f"{label}: one graph replay against the eager step from the "
            f"same state: loss, grad norm, parameters and moments "
            f"bitwise={replay_vs_eager}")
        if not replay_vs_eager:
            raise AssertionError(f"{label}: a graph replay differs from the "
                                 f"eager step")
    # a replay must show the port's kernels the step's count of times; a
    # trace of ~10k kernels now and then misses records (its kernel count
    # moves between traces of one graph), and is taken again
    want = {k: per_step[k] for k in ONCE_PER_CALL}

    def all_there(table):
        got = port_calls(table)
        if got != want:
            log(f"{label}: a profiled replay shows {got}, want {want}")
        return got == want
    graph = step_profile(torch, lambda: program.step(batch),
                         f"{label} graph", table_ok=all_there)
    # 3 unprofiled calls, the card-only traces and one host trace
    if program.graph is None or program.replays != \
            4 + graph["traces"] + (replay_vs_eager is not None):
        raise AssertionError(f"{label}: the program did not replay its "
                             f"graph ({program.replays} replays)")
    replayed = port_calls(graph["table"])
    launches = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    log(f"{label}: one profiled replay ran {replayed} (K2, K3, K6, K7, K9, "
        f"K10: "
        f"kernels launched once a call; K5: its three kernels; trace "
        f"{graph['traces']}); executed launches over the {TRAIN_STEPS} steps"
        f" (warm-up and {TRAIN_STEPS - 1} replays) {launches}")
    if replayed != want:
        raise AssertionError(f"{label}: a replay ran {replayed}, want "
                             f"{want} ({graph['traces']} traces)")
    compared = [("graph", graph, peak)] + (
        [("eager", eager_res, eager_peak)] if eager else [])
    for name, r, pk in compared:
        r["peak_gib"] = pk / 2**30
        r["tokens_per_s"] = tokens / (r["wall_ms"] / 1e3)
        r["share_of_989"] = 6 * n * tokens / (r["wall_ms"] / 1e3) \
            / BF16_FLOP_PER_S
    log(f"{label}: graph{' vs eager' if eager else ''} in one run: "
        + "; ".join(
            f"{name} step_s={r['wall_ms'] / 1e3:.4f} tokens_per_s="
            f"{r['tokens_per_s']:.1f} six_n_t_share={r['share_of_989']:.4f} "
            f"busy_share={r['busy_share']} kernels={r['kernels']} "
            f"peak_gib={r['peak_gib']:.2f}" for name, r, _ in compared)
        + f" capture_seconds={program.capture_seconds:.3f}")
    out = {"params": n, "median_step_s": med, "tokens_per_s": tokens / med,
           "share_of_989": share, "peak_gib": peak / 2**30,
           "peak_reserved_gib": peak_reserved / 2**30,
           "held_gib": max(held[1:]), "state_gib": state_bytes / 2**30,
           "busy_share": graph["busy_share"],
           "loss": [m["loss"] for m in history],
           "grad_norm": [m["grad_norm"] for m in history],
           "launches": launches,
           "wrapper_calls": wrapper_calls, "launches_per_step": per_step,
           "graph": {k: v for k, v in graph.items() if k != "table"},
           "capture_seconds": program.capture_seconds, "pipeline": stats,
           "replay_bitwise_eager": replay_vs_eager}
    if eager:
        out["eager"] = {k: v for k, v in eager_res.items() if k != "table"}
    del program
    gc.collect()
    # the in-place update alone: on a copy of the state where there is room
    # for one, else on the state itself (its last use)
    if eager:
        p_upd, o_upd = (pytree.tree_map(torch.clone, x) for x in (params,
                                                                    opt))
    else:
        p_upd, o_upd = params, opt
    grads = pytree.tree_map(torch.zeros_like, p_upd)
    adamw = cuda_ms(lambda: adamw_update_(grads, o_upd, p_upd,
                                          tcfg.optimizer), reps=3)
    del grads, p_upd, o_upd
    out["op_split"] = op_split(torch, f"{label} graph step", graph["table"],
                               adamw)
    if mamba_layers(cfg):
        log(f"{label}: graph step kernels={graph['kernels']} device_busy_ms="
            f"{graph['busy_ms']:.1f} (mamba2-1.3b at PR 24's final run: "
            f"17,944 kernels, 713.4 ms)")
        m = cfg.mamba
        out["ssd_layer"] = ssd_autograd_ms(torch, K3, dev, (
            TRAIN_BATCH, TRAIN_SEQ, m.n_heads, m.head_dim, m.n_groups,
            m.d_state, "bfloat16"))
    del params, opt, state, batch, graph, eager_res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_resume(torch, dev) -> None:
    """18d: reduced yi-6b on the card, ``train_loop`` to step 2 with a
    checkpoint, then resumed to step 4; equal bit for bit to restoring step
    2 by hand and stepping the same (restarted) batches.  Then
    ``python -m repro_torch.launch.train --arch yi-6b --reduced --steps 3``
    with no ``--device``: it runs on the card by default."""
    import shutil

    import torch.utils._pytree as pytree

    from repro_torch.configs import get_reduced_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.models.transformer import init_params
    from repro_torch.train.loop import (TrainConfig, batch_to_device,
                                        make_train_step, train_loop)
    from repro_torch.train.optimizer import adamw_init

    log("== phase 18d: checkpoint and restart on the card (reduced yi-6b)")
    cfg = get_reduced_config("yi-6b")
    src = SyntheticLM(vocab=cfg.vocab, seq_len=64, batch=4, n_shards=8)
    batches = [src.batch_from_shard(src.load_shard(i)) for i in range(3)]
    tcfg = TrainConfig(checkpoint_every=2)
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        train_loop(cfg, tcfg, iter(batches), 2, checkpoint_dir=str(ckpt),
                   device=dev)
        params, opt, _ = train_loop(cfg, tcfg, iter(batches), 4,
                                    checkpoint_dir=str(ckpt), device=dev)
        mgr = CheckpointManager(str(ckpt))
        template = init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, dev)
        p, o = mgr.restore((template, adamw_init(template, tcfg.optimizer)),
                           2)
        step = make_train_step(cfg, tcfg)
        for b in batches[:2]:
            p, o, _ = step(p, o, batch_to_device(b, dev))
        steps = mgr.steps()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    leaves = list(zip(pytree.tree_leaves((params, opt)),
                      pytree.tree_leaves((p, o))))
    same = sum(bool(torch.equal(a.view(torch.uint8) if a.dim() else a,
                                b.view(torch.uint8) if b.dim() else b))
               for a, b in leaves)
    log(f"resume: checkpoints={steps} step={int(opt['step'])} "
        f"bitwise_equal_tensors={same}/{len(leaves)}")
    if steps != [2, 4] or int(opt["step"]) != 4 or same != len(leaves):
        raise AssertionError("resume differs from restoring by hand")

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b",
         "--reduced", "--steps", "3"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    lines = out.stdout.strip().splitlines()
    for line in lines:
        log(f"  launch.train: {line[:160]}")
    log(f"launch.train: rc={out.returncode} "
        f"seconds={time.perf_counter() - t0:.2f}")
    if out.returncode != 0 or not lines or \
            lines[0] != f"device: {torch.cuda.get_device_name(0)}" or \
            not lines[-1].startswith("done; pipeline stats:"):
        raise AssertionError(f"launch.train failed: {out.stderr[-2000:]}")


def train_phase(torch, counts: dict, dev) -> dict:
    """Phase 18: training on the card.  ``counts``: the kernel modules
    (K2's forward and backward launches must match each step's attention
    layers, K3's, K6's and K7's its Mamba layers, K5's three kernels a
    step)."""
    from repro_torch.configs import get_config
    from repro_torch.train.loop import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig

    train_card_vs_cpu(torch, dev)
    log("== phase 18b: train mamba2-1.3b at full width and depth")
    out = {"mamba2-1.3b": train_cell(torch, get_config("mamba2-1.3b"), dev,
                                     counts, "mamba2-1.3b")}
    yi = get_config("yi-6b")
    cut = dataclasses.replace(yi, n_layers=4)
    log(f"== phase 18c: train yi-6b at full width, n_layers cut from "
        f"{yi.n_layers} to {cut.n_layers}")
    out["yi-6b-4l"] = train_cell(torch, cut, dev, counts, "yi-6b-4l")
    log(f"== phase 18e: train yi-6b at full width and depth ({yi.n_layers} "
        f"layers), bf16 moments, train_loop only")
    out["yi-6b"] = train_cell(
        torch, yi, dev, counts, "yi-6b",
        TrainConfig(optimizer=AdamWConfig(moment_dtype=torch.bfloat16)),
        eager=False)
    train_resume(torch, dev)
    return out


# phases 10-11's serve summaries, by arch
SERVED: dict = {}


def full_serve(torch, arch: str, kernel: str, counts: dict, dev,
               phase: str) -> int:
    """Phases 10-11: ``arch`` at full width and depth served, ``kernel``
    launched once per layer and prefill on its fast route; a Mamba model's
    K6 once a layer in every prefill, K7 there and in the decode graph's
    warm-up and capture, K8 in those two, and K7 and K8 once a layer in
    one profiled replay of the decode graph, K6 never; the replay's
    device-to-device copies fewer than the layers (no state copied back).
    Returns ``kernel``'s launches."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    params = init_model(torch, cfg, arch, dev)
    out = serve_phase(torch, cfg, params, arch, {kernel: cfg.n_layers},
                      counts, dev, phase,
                      route={"K2": "wgmma", "K3": "chunked"}[kernel])
    del params
    free(torch)
    # K9 once a norm and K10 once a gated FFN in every prefill and in the
    # decode graph's warm-up and capture; once each in a replay
    unit = unit_calls(cfg)["serve"]
    want = {k: unit[k] * (out["prefills"] + 2) for k in ("K9", "K10")}
    got = {k: out["launches"][k] for k in want}
    calls = out["token_calls"]
    log(f"{arch}: unit kernel wrapper launches {got} (want {want}); one "
        f"decode replay ran K9 {calls['K9']} and K10 {calls['K10']} times "
        f"(want {unit['K9']} and {unit['K10']}); kernels a token "
        f"{out['token_kernels']}, device ms a token "
        f"{out['token_device_ms']:.3f}")
    if got != want or calls["K9"] != unit["K9"] or \
            calls["K10"] != unit["K10"]:
        raise AssertionError(f"{arch}: the unit's kernels ran {got} / "
                             f"{calls} times")
    n = mamba_layers(cfg)
    if n:
        # K6 once a layer in every prefill, K7 there and in the decode's
        # warm-up and capture, K8 in those two; a replay calls no wrapper
        want = {"K6": n * out["prefills"], "K7": n * (out["prefills"] + 2),
                "K8": 2 * n}
        got = {k: out["launches"][k] for k in want}
        calls = out["token_calls"]
        log(f"{arch}: block kernel wrapper launches {got} (want {want}); "
            f"one decode replay ran {calls}; kernels a token "
            f"{out['token_kernels']} (the unit's norms and residuals as "
            f"plain ops: 877), device ms a token "
            f"{out['token_device_ms']:.3f} (3.166), graph tokens/s "
            f"{out['decode_tokens_per_s_graph']:.2f} (276.63)")
        if got != want or calls["K6"] or calls["K7"] != n or \
                calls["K8"] != n or out["token_memcpy_dtod"] >= n:
            raise AssertionError(f"{arch}: the Mamba block's kernels ran "
                                 f"{got} / {calls} times, "
                                 f"{out['token_memcpy_dtod']} copies a "
                                 f"replay")
    SERVED[arch] = out
    return out["launches"][kernel]


# ---------------------------------------------------------------------------
# phases 19-21: MoE, MLA and the multimodal stubs at full width
# ---------------------------------------------------------------------------

class MoEDrops:
    """While active, wraps the decoder stack's ``moe_apply`` and records, per
    call, its tokens, which routed slots fit their expert's capacity (the
    router recomputed on the same input, ``moe._dispatch``'s ranks) and the
    last token's input.  Kept out of timed runs."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe as TM
        from repro_torch.models import transformer as TT
        self.inner = TT.moe_apply

        def wrapped(params, cfg, x):
            t = x.shape[0] * x.shape[1]
            logits = x.reshape(t, -1).to(cfg.router_dtype) @ params["router"]
            idx = TM._router_probs(cfg, logits)[1]
            keep = TM._dispatch(idx, cfg.n_experts, TM.capacity(cfg, t))[2]
            self.calls.append((keep.reshape(t, cfg.top_k), x[:, -1].float()))
            return self.inner(params, cfg, x)

        TT.moe_apply = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as TT
        TT.moe_apply = self.inner

    def dropped_share(self) -> float:
        kept = sum(int(keep.sum()) for keep, _ in self.calls)
        return 1 - kept / sum(keep.numel() for keep, _ in self.calls)

    def last_token_dropped(self) -> bool:
        return any(not bool(keep[-1].all()) for keep, _ in self.calls)


def deepseek_phase(torch, counts: dict, dev) -> dict:
    """Phase 19: deepseek-v3-671b at full width, its 61 layers cut to 4 (the
    3 dense MLA prelude layers and one MLA/MoE unit, plus the MTP layer
    ``init_params`` builds), served on phase 10's traffic.  MLA's attention
    and the experts are the plain paths (no kernel of ``repro``'s either):
    no K2/K3 launch; K1 schedules.  Then the share of routed slots dropped
    over capacity in one cold prefill (and one decode step), and a
    teacher-forced decode of one token against the prefill of the extended
    prompt: the latent caches at full width, read at the MoE layer's input
    (the logits too where the prefill kept all of that token's routed
    slots)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import decode_step, prefill

    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, n_layers=4)
    label = "deepseek-v3-671b-4l"
    log(f"== phase 19: {label} (n_layers cut from {full.n_layers} to "
        f"{cfg.n_layers}; MTP layer built)")
    params = init_model(torch, cfg, label, dev)
    out = serve_phase(torch, cfg, params, label, {"K2": 0, "K3": 0}, counts,
                      dev, "phase 19")
    tokens, _ = stub_inputs(torch, cfg, PROMPT_LEN + 1, dev)
    with MoEDrops() as pre:
        want = prefill(params, cfg, tokens)[0].float()
    with MoEDrops() as dec:
        _, caches, n = prefill(params, cfg, tokens[:, :PROMPT_LEN],
                               max_len=PROMPT_LEN + 8)
        dec.calls.clear()
        got, _ = decode_step(params, cfg, tokens[:, PROMPT_LEN], caches, n)
    share, decode_share = pre.dropped_share(), dec.dropped_share()
    log(f"{label}: MoE layer, prefill of {PROMPT_LEN + 1} tokens: capacity="
        f"{capacity(cfg.moe, PROMPT_LEN + 1)} routed_slots="
        f"{(PROMPT_LEN + 1) * cfg.moe.top_k} dropped_share={share:.5f} "
        f"last_token_lost_a_slot={pre.last_token_dropped()}; one decode "
        f"step dropped_share={decode_share:.5f}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite decode logits")
    # every MLA layer comes before the MoE layer's FFN: its input at the
    # new token reads the latent caches of all four layers, and routing
    # cannot move it; held to the same 5e-2 relative L2 as the logits
    h_dec, h_pre = dec.calls[0][1], pre.calls[0][1]
    rel = float((h_dec - h_pre).norm() / h_pre.norm())
    log(f"{label}: MoE layer input of the token decoded at {n} (latent "
        f"caches) vs the prefill of {PROMPT_LEN + 1} tokens: rel_l2={rel:.3g}"
        f" max_abs={float((h_dec - h_pre).abs().max()):.3g}")
    if not rel < 5e-2:
        raise AssertionError(f"{label}: the decode's MoE input disagrees "
                             f"with the prefill's")
    what = (f"logits of the token decoded at {n} vs the prefill of "
            f"{PROMPT_LEN + 1} tokens")
    if pre.last_token_dropped():
        # the prefill drops some of that token's routed slots (it ranks
        # last in its experts) and the decode keeps all: information only
        rel = float((got.float() - want).norm() / want.norm())
        log(f"{label}: {what}: rel_l2={rel:.3g} (not held: the prefill "
            f"dropped routed slots of that token)")
    else:
        check_prefill_pair(label, got.float(), want, what)
    out.update(prefill_dropped_share=share, decode_dropped_share=decode_share)
    del params, caches, want, got
    free(torch)
    return out


def multimodal_phases(torch, counts: dict, K2, dev) -> dict:
    """Phases 20-21: paligemma-3b at full width and depth served on phase
    10's traffic (2000-token prompts after 256 prefix positions, S=2256;
    every prefill 18 K2 launches on ``wgmma`` at D=256); arctic-480b at full
    width, 1 of 35 layers (K2 at D=128 with 56/8 heads, G=7) and
    musicgen-large at full width and depth (48 launches at D=64, G=1, 64
    prefix positions, 4 codebooks), one prefill each, musicgen then a few
    decode steps."""
    from repro_torch.configs import get_config

    cfg = get_config("paligemma-3b")
    if K2.route(cfg.attn.head_dim, cfg.dtype) != "wgmma":
        raise AssertionError("paligemma-3b: K2.route names "
                             f"{K2.route(cfg.attn.head_dim, cfg.dtype)}")
    params = init_model(torch, cfg, "paligemma-3b", dev)
    out = {"paligemma-3b": serve_phase(
        torch, cfg, params, "paligemma-3b", {"K2": attn_layers(cfg)},
        counts, dev, "phase 20", route="wgmma")}
    del params
    free(torch)
    full = get_config("arctic-480b")
    cut = dataclasses.replace(full, n_layers=1)
    out["arctic-480b-1l"] = prefill_phase(
        torch, cut, "arctic-480b-1l", K2, dev,
        f"phase 21a (n_layers cut from {full.n_layers} to 1)")
    out["musicgen-large"] = prefill_phase(
        torch, get_config("musicgen-large"), "musicgen-large", K2, dev,
        "phase 21b", decode_steps=8)
    return out


def check_wgmma_256(spills: dict[str, int]) -> None:
    """Phase 7's check, made once phase 8 has timed the kernel: ptxas
    spilled nothing in ``flash_attention_wgmma<256>``."""
    wg256 = {f: b for f, b in spills.items()
             if "flash_attention_wgmmaILi256E" in f}
    log(f"K2 flash_attention_wgmma<256> spill store bytes: "
        f"{list(wg256.values())}")
    if len(wg256) != 1 or any(wg256.values()):
        raise AssertionError(f"K2 flash_attention_wgmma<256>: spill stores "
                             f"{wg256} (want one instantiation, 0 bytes)")


# ---------------------------------------------------------------------------
# phases 22-24: the multi-device layer at mesh size 1 (NCCL)
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 3
MESH_DECODE_STEPS = 4


def card_mesh(shape, axes):
    """A mesh on the card over a one-rank NCCL group (started by the first
    call)."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes)


def bitwise(torch, a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a.reshape(-1).view(torch.uint8),
                    b.reshape(-1).view(torch.uint8)))


# K5's four kernels on a mesh, each once a call
K5_MESH_KERNELS = ("adamw_norm", "adamw_sum", "adamw_finish_total",
                   "adamw_apply")


def k5_mesh_kernels(table) -> dict:
    """How many times a profiled kernel table ran each of K5's mesh
    kernels (names matched whole: ``adamw_finish`` is not one)."""
    def name(key):
        head = key.split("(")[0].split()
        return head[-1] if head else ""
    return {k: sum(e.count for e in table if name(e.key) == k)
            for k in K5_MESH_KERNELS}


def held_gib(torch) -> float:
    """GiB a replayed graph step holds on the card: the blocks allocated
    outside the CUDA graphs' private pools, plus every segment of those
    pools (a replay uses their blocks without the allocator, so
    ``max_memory_allocated`` cannot see them)."""
    total = 0
    for seg in torch.cuda.memory_snapshot():
        private = tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)
        total += seg["total_size"] if private else seg["allocated_size"]
    return total / 2**30


def eager_mesh_step(torch, fn, label: str) -> dict:
    """One eager mesh step ``fn`` (``step_fn.in_place``, DTensor's host
    dispatch of every op), after one untimed call: its wall ms
    unprofiled, then its busy share in a card-only trace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    pwall, busy, n, _ = profiled(torch, fn, host=False)
    share = busy / pwall if busy > 0 else None
    log(f"{label} eager: unprofiled step wall_ms={wall:.2f}; card-only "
        f"profiled step wall_ms={pwall:.2f} device_busy_ms={busy:.2f} "
        f"busy_share={'not measured' if share is None else f'{share:.3f}'}"
        f" kernels={n}")
    return {"wall_ms": wall, "busy_ms": busy, "busy_share": share,
            "kernels": n}


def k5_mesh_timing(torch, label: str, params, opt, ocfg) -> dict:
    """K5 at a placed parameter set on the 1 x 1 mesh, zero gradients, in
    place on the state: one mesh call (norm, ``adamw_sum``, the one-rank
    all-reduce of one float64, ``adamw_finish_total``, apply) beside the
    same update on the local tensors without the mesh (three kernels),
    each timed with CUDA events eagerly (the host's preparation of the
    call included) and as a replay of a CUDA graph holding that one call
    (as the train graph runs it); the graph's device ms by CUDA kernel
    (not measured unless a trace holds K5's four kernels once each); the
    bytes bound (each input read once, each output written once)."""
    import torch.utils._pytree as pytree

    from repro_torch.kernels import adamw as K5
    from repro_torch.train.optimizer import adamw_update_
    grads = pytree.tree_map(torch.zeros_like, params)
    local = [pytree.tree_map(lambda t: t.to_local(), x)
             for x in (grads, opt, params)]

    def mesh_call():
        adamw_update_(grads, opt, params, ocfg)

    def no_mesh_call():
        adamw_update_(*local, ocfg)

    def graphed(fn):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with K5.holding_tables() as held, torch.cuda.graph(graph):
            fn()
        torch.cuda.synchronize()
        return graph, held
    eager_ms = cuda_ms(mesh_call, reps=5)
    eager_no_mesh_ms = cuda_ms(no_mesh_call, reps=5)
    (g_mesh, held_mesh), (g_no_mesh, held_no_mesh) = (
        graphed(mesh_call), graphed(no_mesh_call))
    mesh_ms = cuda_ms(g_mesh.replay, reps=5)
    no_mesh_ms = cuda_ms(g_no_mesh.replay, reps=5)
    split = kernel_split(
        torch, g_mesh.replay, "", split_ok=lambda got: all(
            got.get(k, (0,))[0] == 1 for k in K5_MESH_KERNELS))
    nbytes = sum(t.numel() * t.element_size() for t in
                 pytree.tree_leaves(local[0])) + 2 * sum(
        t.numel() * t.element_size() for t in pytree.tree_leaves(
            (local[2], local[1]["m"], local[1]["v"])))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"{label}: K5 mesh call in a graph ms={mesh_ms:.4f} (norm, sum, "
        f"all-reduce, finish from the total, apply) no_mesh_call_ms="
        f"{no_mesh_ms:.4f} (three kernels, the same local tensors) "
        f"mesh_over_no_mesh={mesh_ms / no_mesh_ms:.4f} bound_ms="
        f"{bound:.4f} (bytes, {nbytes} once); eager calls ms="
        f"{eager_ms:.4f} no_mesh={eager_no_mesh_ms:.4f}; split (device ms "
        f"by CUDA kernel of a replay): " + (
            "not measured" if split is None else " ".join(
                f"{k}={v[1]:.4f}({v[0]})" for k, v in split.items())))
    del grads, local, g_mesh, g_no_mesh, held_mesh, held_no_mesh
    return {"ms": mesh_ms, "no_mesh_ms": no_mesh_ms, "eager_ms": eager_ms,
            "eager_no_mesh_ms": eager_no_mesh_ms, "bound_ms": bound,
            "bytes_once": nbytes, "split_ms": None if split is None else {
                k: v[1] for k, v in split.items()}}


def mesh_batches(cfg, n: int) -> list:
    """The first ``n`` batches phase 18's loader hands ``train_loop``."""
    from repro_torch.data.pipeline import SyntheticLM
    src = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                      n_shards=512)
    return [src.batch_from_shard(src.load_shard(i)) for i in range(n)]


def mesh_train_phase(torch, K5, dev, phase18c: dict) -> dict:
    """Phase 22: yi-6b, full width, 4 layers, on a 1 x 1 mesh through
    ``train_loop(..., mesh=mesh)``: the sharded init, then the mesh
    program (an eager warm-up, one in-place step captured in a CUDA graph
    with DTensor's redistributions, K5's four kernels on the local shards
    and the norm's all-reduce, replayed).  Gates: every loss and grad norm
    bit for bit equal to the no-mesh loop's on the same batches, K5's
    wrapper called in the warm-up and the capture only (8 kernels), a
    profiled replay of a captured mesh program running K5's four kernels
    once each, the checkpoint restored bitwise into the mesh's
    placements.  One eager mesh step (``step_fn.in_place``) is timed
    beside the replay; K5's mesh call is timed alone.  The no-mesh loop
    runs twice, so that a difference can be told from the card's
    run-to-run noise."""
    import shutil
    import statistics

    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.train.loop import (TrainConfig, TrainProgram,
                                        batch_to_device, make_train_step,
                                        train_loop)

    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=4)
    label = "yi-6b-4l-mesh"
    log(f"== phase 22: train {label} on a 1 x 1 (data, model) mesh over "
        f"NCCL through the captured mesh program, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, {MESH_TRAIN_STEPS} steps")
    mesh = card_mesh((1, 1), ("data", "model"))
    batches = mesh_batches(cfg, MESH_TRAIN_STEPS)
    tcfg = TrainConfig(log_every=1)
    plain, again = [], []
    for hist in (plain, again):
        p, o, _ = train_loop(cfg, tcfg, iter(batches), MESH_TRAIN_STEPS,
                             device=dev, log_fn=lambda s, m: hist.append(m))
        del p, o
        free(torch)
    hist = []
    torch.cuda.reset_peak_memory_stats()
    K5.reset_counts()
    params, opt, _ = train_loop(cfg, tcfg, iter(batches), MESH_TRAIN_STEPS,
                                device=dev, mesh=mesh,
                                log_fn=lambda s, m: hist.append(m))
    torch.cuda.synchronize()
    wrapper_calls = K5.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    free(torch)
    losses = [m["loss"] for m in hist]
    norms = [m["grad_norm"] for m in hist]
    want = [m["loss"] for m in plain]
    want_norms = [m["grad_norm"] for m in plain]
    same = [a == b for a, b in zip(losses, want)]
    same_norms = [a == b for a, b in zip(norms, want_norms)]
    times = [m["step_time"] for m in hist]
    med = statistics.median(times[1:])
    log(f"{label}: loss={losses} no_mesh_loss={want} bitwise={same} "
        f"no_mesh_run_to_run_bitwise="
        f"{[m['loss'] for m in again] == want}")
    log(f"{label}: grad_norm={norms} no_mesh={want_norms} "
        f"bitwise={same_norms}")
    log(f"{label}: graph step_s={[round(t, 4) for t in times]} (step 1: "
        f"sharded init done, eager warm-up and capture) median_step_s_2_to_"
        f"{MESH_TRAIN_STEPS}={med:.4f} phase_18c_median_step_s="
        f"{phase18c['median_step_s']:.4f} ratio="
        f"{med / phase18c['median_step_s']:.4f} peak_gib="
        f"{peak / 2**30:.2f} phase_18c_peak_gib={phase18c['peak_gib']:.2f} "
        f"K5 wrapper_calls={wrapper_calls} (4 kernels a call, in the "
        f"warm-up and the capture; the {MESH_TRAIN_STEPS - 1} replays call "
        f"no wrapper, and what a replay runs is read from its trace)")
    if len(hist) != MESH_TRAIN_STEPS or not all(same + same_norms):
        raise AssertionError(f"{label}: the mesh step's losses or grad "
                             f"norms differ from the no-mesh loop's")
    if wrapper_calls != 8:
        raise AssertionError(f"{label}: K5's wrapper launched "
                             f"{wrapper_calls} kernels, want 8 (the warm-up"
                             f" and the capture)")
    if not all(isinstance(t, DTensor) for t in pytree.tree_leaves(params)):
        raise AssertionError(f"{label}: a parameter left the mesh")

    step = make_train_step(cfg, tcfg, mesh)
    batch = batch_to_device(batches[0], dev)
    program = TrainProgram(step, params, opt, batch)
    program.step(batch)                     # warm-up and capture
    graph = step_profile(
        torch, lambda: program.step(batch), f"{label} graph",
        table_ok=lambda t: set(k5_mesh_kernels(t).values()) == {1})
    ran = k5_mesh_kernels(graph["table"])
    log(f"{label}: one profiled replay of the mesh program ran K5's "
        f"kernels {ran} (trace {graph['traces']}) capture_seconds="
        f"{program.capture_seconds:.3f}")
    if set(ran.values()) != {1} or program.graph is None:
        raise AssertionError(f"{label}: a mesh replay ran K5's kernels "
                             f"{ran}")
    del program
    free(torch)
    eager = eager_mesh_step(torch, lambda: step.in_place(params, opt, batch),
                            label)
    log(f"{label}: graph vs eager mesh step in one run: graph step_s="
        f"{graph['wall_ms'] / 1e3:.4f} busy_share={graph['busy_share']} "
        f"eager step_s={eager['wall_ms'] / 1e3:.4f} busy_share="
        f"{eager['busy_share']} eager_over_graph="
        f"{eager['wall_ms'] / graph['wall_ms']:.4f}")
    k5 = k5_mesh_timing(torch, label, params, opt, tcfg.optimizer)

    ckpt = ROOT / "build" / "chip_smoke_mesh_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        mgr = CheckpointManager(str(ckpt))
        mgr.save((params, opt), MESH_TRAIN_STEPS, blocking=True)
        template = pytree.tree_map(torch.zeros_like, (params, opt))
        got = mgr.restore(template, MESH_TRAIN_STEPS)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    pairs = list(zip(pytree.tree_leaves(got), pytree.tree_leaves(
        (params, opt))))
    n_same = sum(isinstance(a, DTensor) and a.placements == b.placements
                 and bitwise(torch, a.to_local(), b.to_local())
                 for a, b in pairs)
    log(f"{label}: checkpoint restored into the mesh's placements: "
        f"bitwise_equal_tensors={n_same}/{len(pairs)}")
    if n_same != len(pairs):
        raise AssertionError(f"{label}: the restored state differs")
    out = {"loss": losses, "no_mesh_loss": want, "bitwise": all(same),
           "grad_norm": norms, "grad_norm_bitwise": all(same_norms),
           "no_mesh_run_to_run_bitwise":
               [m["loss"] for m in again] == want,
           "median_step_s": med,
           "phase_18c_median_step_s": phase18c["median_step_s"],
           "ratio": med / phase18c["median_step_s"],
           "peak_gib": peak / 2**30, "busy_share": graph["busy_share"],
           "graph": {k: v for k, v in graph.items() if k != "table"},
           "eager": eager, "k5_mesh_call": k5,
           "k5_wrapper_calls": wrapper_calls, "k5_kernels_profiled": ran,
           "restored_bitwise": n_same}
    del params, opt, got, template, pairs, graph
    free(torch)
    return out


def mesh_full_depth_phase(torch, K5, dev, phase18e: dict) -> dict:
    """Phase 22b: yi-6b at full width and depth, bf16 moments, three
    steps through ``train_loop(..., mesh=1 x 1)``: the sharded init (each
    leaf placed as it is drawn, the moments made on the placed
    parameters) and the captured mesh program, one copy of the state, as
    18e.  Gates: losses and grad norms bit for bit equal to the first
    three of 18e's, every parameter a DTensor, K5's wrapper called in the
    warm-up and the capture only, and the first step's peak (the init,
    the warm-up and the capture) no more than 2 GiB above what a replayed
    step holds (:func:`held_gib`) and no more than 2 GiB above 18e's
    peak (the allocator's, over a run whose first step is its warm-up and
    capture).  What a replay holds is printed beside 18e's, read the same
    way in the same run.  Then K5's mesh call timed alone."""
    import statistics

    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.train.loop import TrainConfig, train_loop
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config("yi-6b")
    label = "yi-6b-mesh"
    log(f"== phase 22b: train yi-6b at full width and depth "
        f"({cfg.n_layers} layers), bf16 moments, on a 1 x 1 mesh over "
        f"NCCL through the captured mesh program, {MESH_TRAIN_STEPS} steps")
    mesh = card_mesh((1, 1), ("data", "model"))
    batches = mesh_batches(cfg, MESH_TRAIN_STEPS)
    tcfg = TrainConfig(optimizer=AdamWConfig(moment_dtype=torch.bfloat16),
                       log_every=1)
    hist, peaks, held = [], [], []

    def log_fn(s, m):
        hist.append(m)
        peaks.append(torch.cuda.max_memory_allocated())
        held.append(held_gib(torch))
        torch.cuda.reset_peak_memory_stats()

    free(torch)
    torch.cuda.reset_peak_memory_stats()
    K5.reset_counts()
    params, opt, _ = train_loop(cfg, tcfg, iter(batches), MESH_TRAIN_STEPS,
                                device=dev, mesh=mesh, log_fn=log_fn)
    torch.cuda.synchronize()
    wrapper_calls = K5.LAUNCHES
    reserved = torch.cuda.max_memory_reserved()
    placed = all(isinstance(t, DTensor) for t in pytree.tree_leaves(params))
    state_gib = sum(x.numel() * x.element_size() for x in
                    pytree.tree_leaves((params, opt))) / 2**30
    free(torch)
    k5 = k5_mesh_timing(torch, label, params, opt, tcfg.optimizer)
    del params, opt
    free(torch)
    losses = [m["loss"] for m in hist]
    norms = [m["grad_norm"] for m in hist]
    want = phase18e["loss"][:MESH_TRAIN_STEPS]
    want_norms = phase18e["grad_norm"][:MESH_TRAIN_STEPS]
    same = [a == b for a, b in zip(losses, want)]
    same_norms = [a == b for a, b in zip(norms, want_norms)]
    times = [m["step_time"] for m in hist]
    med = statistics.median(times[1:])
    first = peaks[0] / 2**30
    steady = max(held[1:])
    held_18e = phase18e["held_gib"]
    log(f"{label}: loss={losses} phase_18e_loss={want} bitwise={same}")
    log(f"{label}: grad_norm={norms} phase_18e={want_norms} "
        f"bitwise={same_norms}")
    log(f"{label}: graph step_s={[round(t, 4) for t in times]} "
        f"median_step_s_2_to_{MESH_TRAIN_STEPS}={med:.4f} "
        f"phase_18e_median_step_s={phase18e['median_step_s']:.4f} ratio="
        f"{med / phase18e['median_step_s']:.4f}")
    log(f"{label}: first step peak_gib={first:.2f} (the sharded init, the "
        f"eager warm-up and the capture) held_gib steps 2-"
        f"{MESH_TRAIN_STEPS}={steady:.2f} (allocated outside the graph's "
        f"pool plus the pool's segments; allocator peak over those steps "
        f"{max(peaks[1:]) / 2**30:.2f}) first_minus_held="
        f"{first - steady:.2f} phase_18e_peak_gib="
        f"{phase18e['peak_gib']:.2f} first_minus_18e_peak="
        f"{first - phase18e['peak_gib']:.2f} phase_18e_held_gib="
        f"{held_18e:.2f} held_minus_18e_held={steady - held_18e:.2f} "
        f"(target within 1) state_gib={state_gib:.2f} "
        f"peak_reserved_gib={reserved / 2**30:.2f} all_dtensor={placed} "
        f"K5 wrapper_calls={wrapper_calls}")
    if len(hist) != MESH_TRAIN_STEPS or not all(same + same_norms):
        raise AssertionError(f"{label}: losses or grad norms differ from "
                             f"phase 18e's")
    if not placed:
        raise AssertionError(f"{label}: a parameter left the mesh")
    if wrapper_calls != 8:
        raise AssertionError(f"{label}: K5's wrapper launched "
                             f"{wrapper_calls} kernels, want 8")
    if first > steady + 2.0 or first > phase18e["peak_gib"] + 2.0:
        raise AssertionError(f"{label}: the first step's peak {first:.2f} "
                             f"GiB is more than 2 GiB above a replayed "
                             f"step's {steady:.2f} or 18e's peak "
                             f"{phase18e['peak_gib']:.2f}")
    return {"loss": losses, "phase_18e_loss": want, "grad_norm": norms,
            "median_step_s": med,
            "phase_18e_median_step_s": phase18e["median_step_s"],
            "ratio": med / phase18e["median_step_s"],
            "first_step_peak_gib": first, "held_gib": steady,
            "phase_18e_held_gib": held_18e,
            "allocator_peak_gib_steps_2_3": max(peaks[1:]) / 2**30,
            "phase_18e_peak_gib": phase18e["peak_gib"],
            "peak_reserved_gib": reserved / 2**30, "state_gib": state_gib,
            "k5_mesh_call": k5, "k5_wrapper_calls": wrapper_calls}


def mesh_mamba_phase(torch, counts: dict, dev, phase18b: dict) -> dict:
    """Phase 22c: mamba2-1.3b at full width and depth through
    ``train_loop(..., mesh=1 x 1)`` for three steps on 18b's batches: the
    sharded init and the captured mesh program, K3, K6 and K7 forward and
    backward on the local shards under ``local_map`` inside the graph
    (``counts``: the K3, K5, K6, K7 and K8 modules).  Gates: losses and
    grad norms bit for bit equal to 18b's first three, the wrappers called
    the step's count in the warm-up and the capture only, and a profiled
    replay of a captured mesh program running K3, K6 and K7 forward 96
    and backward 48 times and K5's four kernels once each.  One eager mesh
    step (``step_fn.in_place``) is timed beside it."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.train.loop import (TrainConfig, TrainProgram,
                                        batch_to_device, make_train_step,
                                        train_loop)

    cfg = get_config("mamba2-1.3b")
    label = "mamba2-1.3b-mesh"
    log(f"== phase 22c: train mamba2-1.3b at full width and depth on a "
        f"1 x 1 mesh over NCCL through the captured mesh program, "
        f"{MESH_TRAIN_STEPS} steps")
    mesh = card_mesh((1, 1), ("data", "model"))
    batches = mesh_batches(cfg, MESH_TRAIN_STEPS)
    tcfg = TrainConfig(log_every=1)
    per_step = {k: v for k, v in step_calls(cfg, mesh=True).items()
                if not k.startswith("K2")}
    hist = []
    free(torch)
    for mod in counts.values():
        mod.reset_counts()
    params, opt, _ = train_loop(cfg, tcfg, iter(batches), MESH_TRAIN_STEPS,
                                device=dev, mesh=mesh,
                                log_fn=lambda s, m: hist.append(m))
    torch.cuda.synchronize()
    wrapper_calls = {"K3": counts["K3"].LAUNCHES,
                     "K3_backward": counts["K3"].BWD_LAUNCHES,
                     "K5": counts["K5"].LAUNCHES}
    for k in ("K6", "K7", "K9", "K10"):
        wrapper_calls[k] = counts[k].LAUNCHES
        wrapper_calls[f"{k}_backward"] = counts[k].BWD_LAUNCHES
    wrapper_calls["K8"] = counts["K8"].LAUNCHES
    free(torch)
    losses = [m["loss"] for m in hist]
    norms = [m["grad_norm"] for m in hist]
    want = phase18b["loss"][:MESH_TRAIN_STEPS]
    want_norms = phase18b["grad_norm"][:MESH_TRAIN_STEPS]
    same = [a == b for a, b in zip(losses, want)]
    same_norms = [a == b for a, b in zip(norms, want_norms)]
    times = [m["step_time"] for m in hist]
    med = statistics.median(times[1:])
    log(f"{label}: loss={losses} phase_18b_loss={want} bitwise={same}")
    log(f"{label}: grad_norm={norms} phase_18b={want_norms} "
        f"bitwise={same_norms}")
    log(f"{label}: graph step_s={[round(t, 4) for t in times]} "
        f"median_step_s_2_to_{MESH_TRAIN_STEPS}={med:.4f} "
        f"phase_18b_median_step_s={phase18b['median_step_s']:.4f} ratio="
        f"{med / phase18b['median_step_s']:.4f} wrapper_calls="
        f"{wrapper_calls} (per step {per_step}; in the warm-up and the "
        f"capture; the {MESH_TRAIN_STEPS - 1} replays call no wrapper)")
    if len(hist) != MESH_TRAIN_STEPS or not all(same + same_norms):
        raise AssertionError(f"{label}: losses or grad norms differ from "
                             f"phase 18b's")
    if wrapper_calls != {k: 2 * v for k, v in per_step.items()}:
        raise AssertionError(f"{label}: wrapper calls {wrapper_calls}, "
                             f"want twice {per_step}")

    step = make_train_step(cfg, tcfg, mesh)
    batch = batch_to_device(batches[0], dev)
    program = TrainProgram(step, params, opt, batch)
    program.step(batch)                     # warm-up and capture

    def all_there(table):
        got = port_calls(table)
        return all(got[k] == v for k, v in per_step.items() if k != "K5") \
            and set(k5_mesh_kernels(table).values()) == {1}
    graph = step_profile(torch, lambda: program.step(batch),
                         f"{label} graph", table_ok=all_there)
    ran = {**{k: v for k, v in port_calls(graph["table"]).items()
              if k != "K5"}, "K5": k5_mesh_kernels(graph["table"])}
    log(f"{label}: one profiled replay of the mesh program ran {ran} "
        f"(trace {graph['traces']}) capture_seconds="
        f"{program.capture_seconds:.3f}")
    if not all_there(graph["table"]) or program.graph is None:
        raise AssertionError(f"{label}: a mesh replay ran {ran}")
    del program
    free(torch)
    eager = eager_mesh_step(torch, lambda: step.in_place(params, opt, batch),
                            label)
    log(f"{label}: graph vs eager mesh step in one run: graph step_s="
        f"{graph['wall_ms'] / 1e3:.4f} busy_share={graph['busy_share']} "
        f"eager step_s={eager['wall_ms'] / 1e3:.4f} busy_share="
        f"{eager['busy_share']} eager_over_graph="
        f"{eager['wall_ms'] / graph['wall_ms']:.4f}")
    out = {"loss": losses, "phase_18b_loss": want, "grad_norm": norms,
           "median_step_s": med,
           "phase_18b_median_step_s": phase18b["median_step_s"],
           "ratio": med / phase18b["median_step_s"],
           "busy_share": graph["busy_share"],
           "graph": {k: v for k, v in graph.items() if k != "table"},
           "eager": eager, "wrapper_calls": wrapper_calls,
           "replay_ran": ran}
    del params, opt, graph
    free(torch)
    return out


def _prefill_and_decode(torch, params, cfg, tokens, pe, max_len: int,
                        feed=None):
    """Logits of a prefill and of MESH_DECODE_STEPS decode steps, fed
    ``feed`` (greedy when None); returns (logits list, fed tokens)."""
    from repro_torch.models.transformer import decode_step, prefill
    with torch.no_grad():
        logits, caches, n = prefill(params, cfg, tokens, pe, max_len=max_len)
        outs, fed = [logits], []
        for i in range(MESH_DECODE_STEPS):
            tok = feed[i] if feed is not None else \
                logits.full_tensor().argmax(-1) if hasattr(
                    logits, "full_tensor") else logits.argmax(-1)
            fed.append(tok)
            logits, caches = decode_step(params, cfg, tok, caches, n + i)
            outs.append(logits)
    return outs, fed


def mesh_serve_phase(torch, counts: dict, dev) -> dict:
    """Phase 23: serve placements on a 1 x 1 mesh."""
    from torch.distributed.tensor import DTensor

    import repro_torch.kernels.ops as ops
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.ctx import sharding_hints
    from repro_torch.launch.dryrun import _decode_hints
    from repro_torch.launch.shardings import distribute, param_shardings
    from repro_torch.models.transformer import prefill

    mesh = card_mesh((1, 1), ("data", "model"))
    out = {}
    for arch, kernel, route in (("yi-6b", "K2", "wgmma"),
                                ("mamba2-1.3b", "K3", "chunked")):
        cfg = get_config(arch)
        log(f"== phase 23: {arch} at full width and depth, serve "
            f"placements on a 1 x 1 mesh, {PROMPT_LEN}-token prefill and "
            f"{MESH_DECODE_STEPS} decode steps")
        params = init_model(torch, cfg, arch, dev)
        tokens, pe = stub_inputs(torch, cfg, PROMPT_LEN, dev)
        max_len = PROMPT_LEN + MESH_DECODE_STEPS + 8
        want, fed = _prefill_and_decode(torch, params, cfg, tokens, pe,
                                        max_len)

        def plain_prefill():
            with torch.no_grad():
                prefill(params, cfg, tokens, pe, max_len=max_len)
        plain_wall, plain_busy, _, _ = profiled(torch, plain_prefill,
                                                host=False)
        placed = distribute(params, mesh,
                            param_shardings(params, mesh, "serve", cfg))
        hints = _decode_hints(cfg, ShapeSpec("serve", max_len, 1, "decode"),
                              mesh)
        calls = {"n": 0}
        inner = ops.per_rank

        def counted(*a, **kw):
            calls["n"] += 1
            return inner(*a, **kw)

        for mod in counts.values():
            mod.reset_counts()
        ops.per_rank = counted
        try:
            with sharding_hints(**hints):
                with torch.no_grad():
                    prefill(placed, cfg, tokens, pe, max_len=max_len)
                torch.cuda.synchronize()
                launches = counts[kernel].LAUNCHES
                on_route = counts[kernel].ROUTE_LAUNCHES[route]
                block = {k: counts[k].LAUNCHES for k in ("K6", "K7", "K9",
                                                          "K10")}
                prefill_calls = calls["n"]
                got, _ = _prefill_and_decode(torch, placed, cfg, tokens, pe,
                                             max_len, feed=fed)
        finally:
            ops.per_rank = inner

        def mesh_prefill():
            with sharding_hints(**hints), torch.no_grad():
                prefill(placed, cfg, tokens, pe, max_len=max_len)
        mesh_wall, mesh_busy, _, _ = profiled(torch, mesh_prefill,
                                              host=False)
        # CUDA kernels of the kernel's name in one traced mesh prefill, as
        # phases 10-11's profile counts them (K3's chunked route is three
        # kernels a call).  torch.profiler now and then loses a record (a
        # yi-6b trace once held 31 of its 32 K2 kernels while the wrapper
        # counted 32): a trace that holds another count is taken again, up
        # to three in all, and the gate below reads the last
        per_call = {"K2": 1, "K3": 3}[kernel]
        for taken in range(1, 4):
            traced, _ = device_kernels(torch, mesh_prefill, {
                "K2": "flash_attention_", "K3": "ssd_"}[kernel])
            if traced is None or traced == per_call * cfg.n_layers:
                break
            log(f"{arch} mesh: trace {taken} holds {traced} {kernel} "
                f"kernels, want {per_call * cfg.n_layers}")
        rows = []
        for i, (g, w) in enumerate(zip(got, want)):
            if not isinstance(g, DTensor):
                raise AssertionError(f"{arch}: logits left the mesh")
            g = g.full_tensor()
            rows.append((i, bitwise(torch, g, w), float(
                (g.float() - w.float()).norm() / w.float().norm())))
        log(f"{arch} mesh: {kernel}_launches={launches} on_{route}="
            f"{on_route} K6_K7_K9_K10_launches={block} per_rank_calls="
            f"{prefill_calls} traced_cuda_kernels="
            f"{'not measured' if traced is None else traced} (one prefill, "
            f"trace {taken}; {per_call} a launch); "
            f"logits prefill+decode vs no mesh (step, bitwise, rel_l2)="
            f"{rows}")
        log(f"{arch} mesh: prefill card-only profiled wall_ms="
            f"{mesh_wall:.2f} device_busy_ms={mesh_busy:.2f}; no mesh wall_ms="
            f"{plain_wall:.2f} device_busy_ms={plain_busy:.2f}")
        if launches != cfg.n_layers or on_route != launches:
            raise AssertionError(f"{arch}: {kernel} launched {launches} "
                                 f"times ({on_route} on {route}) for "
                                 f"{cfg.n_layers} layers")
        if traced is not None and traced != per_call * cfg.n_layers:
            raise AssertionError(f"{arch}: the trace holds {traced} "
                                 f"{kernel} kernels for {cfg.n_layers} "
                                 f"layers")
        # a Mamba layer maps its conv (K6), its SSD (K3) and its gated
        # norm (K7) over the mesh, an attention layer its attention (K2),
        # every norm its K9 and every gated FFN its K10
        mamba = mamba_layers(cfg)
        unit = unit_calls(cfg)["serve"]
        if prefill_calls != cfg.n_layers + 2 * mamba + unit["K9"] + \
                unit["K10"] or block != {"K6": mamba, "K7": mamba, **unit}:
            raise AssertionError(f"{arch}: {prefill_calls} per-rank calls "
                                 f"and K6/K7/K9/K10 launches {block} for "
                                 f"{cfg.n_layers} layers")
        if not all(r < 1e-3 for _, _, r in rows):
            raise AssertionError(f"{arch}: mesh logits disagree")
        out[arch] = {"launches": {kernel: launches},
                     "traced_cuda_kernels": traced,
                     "traces": taken,
                     "per_rank_calls": prefill_calls,
                     "block_launches": block,
                     "bitwise": [b for _, b, _ in rows],
                     "max_rel_l2": max(r for _, _, r in rows),
                     "prefill_wall_ms": mesh_wall,
                     "prefill_device_ms": mesh_busy,
                     "no_mesh_prefill_wall_ms": plain_wall,
                     "no_mesh_prefill_device_ms": plain_busy}
        del params, placed, want, got
        free(torch)
    out["deepseek-v3-671b-moe-layer"] = mesh_moe_case(torch, mesh, dev)
    return out


def mesh_moe_case(torch, mesh, dev) -> dict:
    """Phase 23, MoE: one deepseek-v3-671b MoE layer at full width through
    ``moe_apply_ep`` in train and serve mode against ``moe_apply`` on the
    same 2000 tokens; gate: relative L2 below 1e-3 and aux within 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shardings import distribute, param_shardings
    from repro_torch.models.moe import (make_moe_params, moe_apply,
                                        moe_apply_ep)

    mcfg = get_config("deepseek-v3-671b").moe
    log(f"== phase 23: one deepseek-v3-671b MoE layer ({mcfg.n_experts} "
        f"experts of {mcfg.d_model} x {mcfg.d_ff_expert}, top-"
        f"{mcfg.top_k}) through moe_apply_ep on the 1 x 1 mesh")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = make_moe_params(gen, mcfg, torch.bfloat16)
    x = torch.randn((1, PROMPT_LEN, mcfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    log(f"moe layer: allocated_gib="
        f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    with torch.no_grad():
        want, aux_want = moe_apply(p, mcfg, x)
    out = {}
    for mode in ("train", "serve"):
        tree = {"mlp": p}
        placed = distribute(tree, mesh, param_shardings(tree, mesh, mode))
        with torch.no_grad():
            y, aux = moe_apply_ep(placed["mlp"], mcfg, x, mesh, ("data",),
                                  mode)
        y, aux = y.full_tensor(), float(aux.full_tensor())
        rel = float((y.float() - want.float()).norm() / want.float().norm())
        same = bitwise(torch, y, want)
        log(f"moe layer {mode}: weights {placed['mlp']['w_gate'].placements}"
            f" bitwise={same} rel_l2={rel:.3g} aux={aux:.6f} moe_apply_aux="
            f"{float(aux_want):.6f} allocated_gib="
            f"{torch.cuda.memory_allocated() / 2**30:.2f}")
        if not (rel < 1e-3 and abs(aux - float(aux_want))
                <= 1e-3 * abs(float(aux_want))):
            raise AssertionError(f"moe_apply_ep ({mode}) disagrees with "
                                 f"moe_apply")
        out[mode] = {"bitwise": same, "rel_l2": rel}
        del placed, y
    del p, x, want
    free(torch)
    return out


def compression_roofline_phase(torch, dev, cells: dict) -> dict:
    """Phase 24: the compressed all-reduce over NCCL, then each cell's
    roofline terms and measured fraction.  ``cells``: label -> (config,
    ShapeSpec, device seconds, wall seconds)."""
    from repro_torch.distributed.compression import (compressed_all_reduce,
                                                     quantize_int8)
    from repro_torch.roofline.analysis import (measured_roofline_fraction,
                                               roofline_terms)
    from repro_torch.roofline.flops_model import (cell_flops,
                                                  cell_hbm_bytes,
                                                  kv_cache_bytes,
                                                  param_bytes)

    log("== phase 24: compressed all-reduce on a 1 x 1 x 1 (pod, data, "
        "model) mesh over NCCL, then the roofline")
    mesh = card_mesh((1, 1, 1), ("pod", "data", "model"))
    x = torch.randn(1 << 20 | 77, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    got = compressed_all_reduce(x, mesh.get_group("pod"))
    q, scale = quantize_int8(x)
    deq = (q.float() * scale).reshape(-1)[:x.numel()]
    per = scale.repeat_interleave(256)[:x.numel()]
    err = (got - x).abs()
    # two bf16 roundings of the payload: the scale's and the product's
    bound = per / 2 + deq.abs() * (2.0 ** -7 + 2.0 ** -16)
    quant_err = float(((deq - x).abs() / per).max())
    log(f"compressed all-reduce: n={x.numel()} max_err_over_scale="
        f"{float((err / per).max()):.4f} max_quant_err_over_scale="
        f"{quant_err:.4f} within_bound={bool((err <= bound).all())}")
    if not (quant_err <= 0.5 and bool((err <= bound).all())):
        raise AssertionError("compressed all-reduce: error past its bound")
    smi = smi_line()
    rows = {}
    for label, (cfg, shape, device_s, wall_s) in cells.items():
        entry = {"shape": shape.name, "n_devices": 1,
                 "flops": cell_flops(cfg, shape, 1,
                                     remat=shape.kind == "train")["global"],
                 "hbm_model_bytes": cell_hbm_bytes(cfg, shape,
                                                   1)["per_device"],
                 "min_hbm_bytes": param_bytes(cfg) + (
                     kv_cache_bytes(cfg, shape.global_batch, shape.seq_len)
                     if shape.kind != "train" else 0.0),
                 "collective_bytes": {}}
        terms = roofline_terms(entry, cfg, shape)
        rows[label] = {
            "t_compute_ms": terms["t_compute_s"] * 1e3,
            "t_memory_ms": terms["t_memory_s"] * 1e3,
            "dominant": terms["dominant"],
            "ideal_ms": max(terms["ideal_compute_s"],
                            terms["ideal_memory_s"]) * 1e3,
            "device_ms": device_s * 1e3, "wall_ms": wall_s * 1e3,
            "roofline_fraction_device": measured_roofline_fraction(
                terms, device_s),
            "roofline_fraction_wall": measured_roofline_fraction(
                terms, wall_s)}
        log(f"roofline {label} ({smi}): " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rows[label].items()))
    return {"compression_max_err_over_scale": float((err / per).max()),
            "roofline": rows}


def mesh_phases(torch, counts: dict, K5, dev, trained: dict) -> dict:
    """Phases 22-24; ``trained``: phase 18's summary."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec

    train_shape = ShapeSpec("train_card", TRAIN_SEQ, TRAIN_BATCH, "train")
    prefill_shape = ShapeSpec("prefill_card", PROMPT_LEN, 1, "prefill")
    try:
        out = {"phase22": mesh_train_phase(torch, K5, dev,
                                           trained["yi-6b-4l"])}
        out["phase22b"] = mesh_full_depth_phase(torch, K5, dev,
                                                trained["yi-6b"])
        out["phase22c"] = mesh_mamba_phase(
            torch, {"K5": K5, **{k: counts[k] for k in ("K3", "K6", "K7",
                                                        "K8", "K9", "K10")}},
            dev, trained["mamba2-1.3b"])
        out["phase23"] = mesh_serve_phase(torch, counts, dev)
        yi4 = dataclasses.replace(get_config("yi-6b"), n_layers=4)
        cells = {}
        for label, cfg in (("18b mamba2-1.3b", get_config("mamba2-1.3b")),
                           ("18c yi-6b-4l", yi4)):
            t = trained[label.split()[1]]
            cells[label] = (cfg, train_shape,
                            t["median_step_s"] * (t["busy_share"] or 0.0),
                            t["median_step_s"])
        for label, cfg, key in (("22 yi-6b-4l mesh", yi4, "phase22"),
                                ("22c mamba2-1.3b mesh",
                                 get_config("mamba2-1.3b"), "phase22c")):
            t = out[key]
            cells[label] = (cfg, train_shape, t["median_step_s"]
                            * (t["busy_share"] or 0.0), t["median_step_s"])
        for arch in ("yi-6b", "mamba2-1.3b"):
            t = out["phase23"][arch]
            cells[f"23 {arch} prefill"] = (
                get_config(arch), prefill_shape,
                t["no_mesh_prefill_device_ms"] / 1e3,
                t["no_mesh_prefill_wall_ms"] / 1e3)
        out["phase24"] = compression_roofline_phase(torch, dev, cells)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def mesh_launches(out: dict) -> dict:
    """The mesh train phases' K5 and K3 counts for the kernels line, each
    counted in this run: the wrappers' counts over ``train_loop(...,
    mesh=)`` (the warm-up and the capture), and the kernels one profiled
    replay of a captured mesh program ran."""
    ran = out["phase22c"]["replay_ran"]
    return {
        "K5": {"replay_launches_mesh": {
                   "yi-6b-4l (phase 22)":
                       out["phase22"]["k5_kernels_profiled"],
                   "mamba2-1.3b (phase 22c)": ran["K5"]},
               "wrapper_launches_mesh": {
                   "yi-6b-4l (phase 22)": out["phase22"]["k5_wrapper_calls"],
                   "yi-6b (phase 22b)": out["phase22b"]["k5_wrapper_calls"],
                   "mamba2-1.3b (phase 22c)":
                       out["phase22c"]["wrapper_calls"]["K5"]},
               "mesh_call_ms": {
                   "yi-6b-4l": out["phase22"]["k5_mesh_call"],
                   "yi-6b": out["phase22b"]["k5_mesh_call"]}},
        "K3": {"wrapper_launches_train_mamba2_1_3b_mesh":
                   out["phase22c"]["wrapper_calls"]["K3"],
               "replay_launches_train_mamba2_1_3b_mesh": ran["K3"]},
        "K3_backward": {
            "wrapper_launches_mesh":
                out["phase22c"]["wrapper_calls"]["K3_backward"],
            "replay_launches_mesh": ran["K3_backward"]}}


def mesh_train_only(torch, K2, K3, K5, mamba, unit, dev) -> dict:
    """``--only mesh``: phases 18b, 18c and 18e (the no-mesh cells the
    mesh phases are held to), then 22, 22b and 22c; their summary line."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.train.loop import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig
    counts = {"K2": K2, "K3": K3, "K5": K5, **dict(zip(("K6", "K7", "K8"),
                                                       mamba)),
              **dict(zip(("K9", "K10"), unit))}
    yi = get_config("yi-6b")
    log("== phase 18b: train mamba2-1.3b at full width and depth")
    trained = {"mamba2-1.3b": train_cell(torch, get_config("mamba2-1.3b"),
                                         dev, counts, "mamba2-1.3b")}
    log("== phase 18c: train yi-6b at full width, n_layers cut to 4")
    trained["yi-6b-4l"] = train_cell(
        torch, dataclasses.replace(yi, n_layers=4), dev, counts, "yi-6b-4l")
    log("== phase 18e: train yi-6b at full width and depth, bf16 moments")
    trained["yi-6b"] = train_cell(
        torch, yi, dev, counts, "yi-6b",
        TrainConfig(optimizer=AdamWConfig(moment_dtype=torch.bfloat16)),
        eager=False)
    try:
        out = {"phase22": mesh_train_phase(torch, K5, dev,
                                           trained["yi-6b-4l"]),
               "phase22b": mesh_full_depth_phase(torch, K5, dev,
                                                 trained["yi-6b"]),
               "phase22c": mesh_mamba_phase(
                   torch, {k: counts[k] for k in ("K3", "K5", "K6", "K7",
                                                  "K8", "K9", "K10")},
                   dev, trained["mamba2-1.3b"])}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    log("phases 22-22c summary: " + json.dumps(out))
    counted = mesh_launches(out)
    return [{"name": "adamw", **counted["K5"]},
            {"name": "ssd_scan", **counted["K3"]},
            {"name": "ssd_scan_backward", **counted["K3_backward"]}]


def run_only(torch, np, only, built, K2, K3, K4, K5, mamba, unit, T_rnn,
             nvcc, dev) -> int:
    """``--only``: the named kernels' phases (7-8b for K2 and its
    backward, 9-9b for K3 and
    its backward, 9c-9d for K5, 9e for K6, K7 and K8 (``mamba``), 9f for
    K9 and K10 (``unit``), 14 for K4; ``mesh``: 18b, 18c, 18e, 22, 22b,
    22c) and their records as one ``{"kernels": [...]}`` line."""
    records = []
    if "k2" in only:
        log("== phase 7: build K2 and K2's backward")
        spills = log_build("K2", *built["K2"])
        bwd_spills = log_build("K2 backward", *built["K2 backward"])
        records.append(phase_k2(torch, K2, dev))
        check_wgmma_256(spills)
        check_bwd_spills(bwd_spills)
        records.append(phase_k2_backward(torch, K2, dev))
    if "k3" in only:
        log("== phase 7: build K3 and K3's backward")
        log_build("K3", *built["K3"])
        log_build("K3 backward", *built["K3 backward"])
        records += [phase_k3(torch, K3, dev), phase_k3_backward(torch, K3,
                                                                dev)]
    if "k5" in only:
        log_build("K5", *built["K5"])
        records.append(phase_k5(torch, K5, dev))
        records[-1]["mesh_two_ranks"] = phase_k5_mesh(torch)
    if "mamba" in only:
        for name in ("K6", "K7", "K8"):
            log_build(name, *built[name])
        got = phase_mamba_kernels(torch, *mamba, dev)
        records += [got["K6"], got["K7"], got["K8"]]
    if "unit" in only:
        for name in ("K9", "K10"):
            log_build(name, *built[name])
        got = phase_unit_kernels(torch, *unit, dev)
        records += [got["K9"], got["K10"]]
    if "mesh" in only:
        if "k2" not in only:
            log_build("K2", *built["K2"])
            check_bwd_spills(log_build("K2 backward", *built["K2 backward"]))
        if "k3" not in only:
            log_build("K3", *built["K3"])
            log_build("K3 backward", *built["K3 backward"])
        if "k5" not in only:
            log_build("K5", *built["K5"])
        if "mamba" not in only:
            for name in ("K6", "K7"):
                log_build(name, *built[name])
        if "unit" not in only:
            for name in ("K9", "K10"):
                log_build(name, *built[name])
        records += mesh_train_only(torch, K2, K3, K5, mamba, unit, dev)
    if "k4" in only:
        log_build("K4", *built["K4"])
        log_build("K4 probe", *built["K4 probe"])
        records.append({"name": "gru_fit",
                        **phase_k4(torch, np, K4, T_rnn, nvcc, dev)})
    log(json.dumps({"kernels": records}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Smoke run of the PyTorch port on one CUDA card.")
    parser.add_argument(
        "--only", nargs="+",
        choices=("k2", "k3", "k4", "k5", "mamba", "unit", "mesh"),
        help="run only these kernels' builds and phases (7-8b: K2 and its "
             "backward, 9-9b: K3 and its backward, 9c-9d: K5, 9e: the Mamba "
             "block's K6, K7 and K8, 9f: the unit's K9 and K10, 14: K4; "
             "mesh: K2's, K3's, K5's, K6's, K7's, K9's and K10's builds, "
             "18b, 18c, 18e, 22, 22b and 22c) and print their records; no "
             "ok line")
    args = parser.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not all((SRC / "repro_torch" / "csrc" / f"{name}.cu").is_file()
               for name in ("arima_bank", "flash_attention",
                            "flash_attention_bwd", "ssd_scan",
                            "ssd_scan_bwd", "gru_fit", "gru_latency_probe",
                            "adamw", "mamba_conv", "gated_norm",
                            "mamba_decode", "unit_norm", "swiglu_gate")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    import repro_torch.core as T
    import repro_torch.core.arima as T_arima
    import repro_torch.core.rnn_predictor as T_rnn
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as K5
    from repro_torch.kernels import arima_bank as K
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.kernels import gated_norm as K7
    from repro_torch.kernels import gru_fit as K4
    from repro_torch.kernels import mamba_conv as K6
    from repro_torch.kernels import mamba_decode as K8
    from repro_torch.kernels import nvcc
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.kernels import swiglu_gate as K10
    from repro_torch.kernels import unit_norm as K9

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 0: device")
    smi = smi_line()
    log(smi)
    log(f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"device={torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()}")

    starts = {"K1": K.start_build, "K2": K2.start_build,
              "K2 backward": K2.start_build_backward,
              "K3": K3.start_build, "K3 backward": K3.start_build_backward,
              "K4": K4.start_build, "K5": K5.start_build,
              "K6": K6.start_build, "K7": K7.start_build,
              "K8": K8.start_build, "K9": K9.start_build,
              "K10": K10.start_build,
              "K4 probe": lambda verbose: nvcc.start(
                  "gru_latency_probe", K4.NVCC_FLAGS, verbose)}
    if args.only:
        log(f"== phase 1: build {' and '.join(args.only)}")
        wanted = set(args.only) | ({"k2", "k3", "k5", "k6", "k7", "k9", "k10"}
                                   if "mesh" in args.only else set()) | (
            {"k6", "k7", "k8"} if "mamba" in args.only else set()) | (
            {"k9", "k10"} if "unit" in args.only else set())
        starts = {name: start for name, start in starts.items()
                  if name.split()[0].lower() in wanted}
    else:
        log("== phase 1: build K1 (K2, K2's backward, K3, K3's backward, "
            "K4, K4's latency probe, K5, K6, K7, K8, K9 and K10 build "
            "alongside, one nvcc each)")
    t_build = time.perf_counter()
    builds = {name: start(verbose=True) for name, start in starts.items()}
    # collected in turn: each time is from the common start to the moment
    # that build was collected, so at least its own nvcc time
    built = {name: (b.wait(), time.perf_counter() - t_build)
             for name, b in builds.items()}
    dev = torch.device("cuda")
    if args.only:
        return run_only(torch, np, args.only, built, K2, K3, K4, K5,
                        (K6, K7, K8), (K9, K10), T_rnn, nvcc, dev)
    spills = log_build("K1", *built["K1"])
    reg_spills = {f: b for f, b in spills.items() if "fit_211" in f}
    if len(reg_spills) != 5 or any(reg_spills.values()):
        raise AssertionError(f"K1 register path: spill stores {reg_spills} "
                             f"(want 0 for each of the 5 instantiations)")

    kernels, reuse = drive(torch, np, T, T_arima, K, dev)

    log("== phase 7: build K2, K2's backward, K3, K3's backward, K5, K6, "
        "K7, K8, K9 and K10")
    wg_spills = log_build("K2", *built["K2"])
    bwd_spills = log_build("K2 backward", *built["K2 backward"])
    for name in ("K3", "K3 backward", "K5", "K6", "K7", "K8", "K9", "K10"):
        log_build(name, *built[name])
    k2 = phase_k2(torch, K2, dev)
    check_wgmma_256(wg_spills)
    check_bwd_spills(bwd_spills)
    k2b = phase_k2_backward(torch, K2, dev)
    k3 = phase_k3(torch, K3, dev)
    k3b = phase_k3_backward(torch, K3, dev)
    k5 = phase_k5(torch, K5, dev)
    k5["mesh_two_ranks"] = phase_k5_mesh(torch)
    block = phase_mamba_kernels(torch, K6, K7, K8, dev)
    unit = phase_unit_kernels(torch, K9, K10, dev)
    counters_lm = {"K1": K, "K2": K2, "K3": K3, "K6": K6, "K7": K7,
                   "K8": K8, "K9": K9, "K10": K10}
    k2["launches"] = full_serve(torch, "yi-6b", "K2", counters_lm, dev,
                                "phase 10")
    k3["launches"] = full_serve(torch, "mamba2-1.3b", "K3", counters_lm,
                                dev, "phase 11")
    k2["launches_stablelm_12b"] = prefill_phase(
        torch, get_config("stablelm-12b"), "stablelm-12b", K2, dev,
        "phase 12")
    kernels[0]["launches_interval_hpm"] = interval_phase(T, K, dev, reuse)

    log_build("K4", *built["K4"])
    log_build("K4 probe", *built["K4 probe"])
    k4 = phase_k4(torch, np, K4, T_rnn, nvcc, dev)
    launches = phase_gru_vs_arima(torch, np, K, K4, T_arima, T_rnn, dev)
    kernels[0]["launches_gru_vs_arima"] = launches["K1"]
    k2["generic"], k3["generic"] = phase_generic_routes(torch, K2, K3, dev)
    served = reduced_serve_phase(torch, counters_lm, dev)
    for key, rec in (("K2", k2), ("K3", k3)):
        rec["launches_reduced_serve"] = {a: n[key] for a, n in served.items()
                                         if n[key]}
    trained = train_phase(torch, {"K2": K2, "K3": K3, "K5": K5, "K6": K6,
                                  "K7": K7, "K8": K8, "K9": K9, "K10": K10},
                          dev)
    log("phase 18 summary: " + json.dumps(trained))
    mamba = trained["mamba2-1.3b"]
    for cell in ("yi-6b", "yi-6b-4l"):
        key = cell.replace("-", "_")
        k2[f"launches_train_{key}"] = trained[cell]["launches"]["K2"]
        k2[f"wrapper_calls_train_{key}"] = \
            trained[cell]["wrapper_calls"]["K2"]
        k2b[f"launches_{key}" if cell != "yi-6b" else "launches"] = \
            trained[cell]["launches"]["K2_backward"]
        k2b[f"wrapper_calls_train_{key}"] = \
            trained[cell]["wrapper_calls"]["K2_backward"]
        k2b[f"launches_per_step_{key}"] = \
            trained[cell]["launches_per_step"]["K2_backward"]
        k2b[f"train_step_device_ms_{key}"] = {
            part: trained[cell]["op_split"].get(f"K2 {part}")
            for part in ("forward", "backward")}
    k3["launches_train_mamba2_1_3b"] = mamba["launches"]["K3"]
    k3["wrapper_calls_train_mamba2_1_3b"] = mamba["wrapper_calls"]["K3"]
    k3b["launches"] = mamba["launches"]["K3_backward"]
    k3b["wrapper_calls"] = mamba["wrapper_calls"]["K3_backward"]
    k3b["launches_per_step"] = mamba["launches_per_step"]["K3_backward"]
    k3b["graph_replays_train_mamba2_1_3b"] = TRAIN_STEPS - 1
    k3b["plain_autograd_ssd_chunked"] = mamba["ssd_layer"]
    k5["launches"] = mamba["launches"]["K5"]
    k5["wrapper_launches"] = mamba["wrapper_calls"]["K5"]
    k5["launches_per_step"] = mamba["launches_per_step"]["K5"]
    k5["launches_yi_6b_full_depth"] = trained["yi-6b"]["launches"]["K5"]
    served_mamba = SERVED["mamba2-1.3b"]
    for key in ("K6", "K7"):
        rec = block[key]
        rec["launches"] = mamba["launches"][key]
        rec["launches_backward"] = mamba["launches"][f"{key}_backward"]
        rec["wrapper_calls_train_mamba2_1_3b"] = {
            k: mamba["wrapper_calls"][k] for k in (key, f"{key}_backward")}
        rec["launches_serve_mamba2_1_3b"] = served_mamba["launches"][key]
        rec["train_step_device_ms"] = {
            part: mamba["op_split"].get(f"{key} {part}")
            for part in ("forward", "backward")}
    for key in ("K9", "K10"):
        rec = unit[key]
        rec["launches"] = trained["yi-6b-4l"]["launches"][key]
        rec["launches_backward"] = \
            trained["yi-6b-4l"]["launches"][f"{key}_backward"]
        rec["launches_train"] = {
            cell: {k: trained[cell]["launches"][k]
                   for k in (key, f"{key}_backward")}
            for cell in ("mamba2-1.3b", "yi-6b-4l", "yi-6b")}
        rec["wrapper_calls_train"] = {
            cell: {k: trained[cell]["wrapper_calls"][k]
                   for k in (key, f"{key}_backward")}
            for cell in ("mamba2-1.3b", "yi-6b-4l", "yi-6b")}
        rec["train_step_device_ms"] = {
            cell: {part: trained[cell]["op_split"].get(f"{key} {part}")
                   for part in ("forward", "backward")}
            for cell in ("mamba2-1.3b", "yi-6b-4l", "yi-6b")}
        rec["launches_serve"] = {a: SERVED[a]["launches"][key]
                                 for a in SERVED}
        rec["launches_per_decode_replay"] = {
            a: SERVED[a]["token_calls"][key] for a in SERVED}
    block["K8"]["launches"] = served_mamba["launches"]["K8"]
    block["K8"]["launches_per_decode_replay"] = \
        served_mamba["token_calls"]["K8"]
    k5["train_step_device_ms"] = {
        cell: trained[cell]["op_split"].get("K5")
        for cell in ("mamba2-1.3b", "yi-6b-4l", "yi-6b")}
    big = {"deepseek-v3-671b-4l": deepseek_phase(torch, counters_lm, dev)}
    big.update(multimodal_phases(torch, counters_lm, K2, dev))
    log("phases 19-21 summary: " + json.dumps(big))
    meshed = mesh_phases(torch, counters_lm, K5, dev, trained)
    log("phases 22-24 summary: " + json.dumps(meshed))
    k2["launches_mesh_prefill_yi_6b"] = \
        meshed["phase23"]["yi-6b"]["launches"]["K2"]
    k3["launches_mesh_prefill_mamba2_1_3b"] = \
        meshed["phase23"]["mamba2-1.3b"]["launches"]["K3"]
    counted = mesh_launches(meshed)
    k5.update(counted["K5"])
    k3.update(counted["K3"])
    k3b.update(counted["K3_backward"])
    k2["launches_paligemma_3b"] = big["paligemma-3b"]["launches"]["K2"]
    k2["launches_arctic_480b_1l"] = big["arctic-480b-1l"]
    k2["launches_musicgen_large"] = big["musicgen-large"]
    kernels += [k2, k2b, k3, k3b, k5, block["K6"], block["K7"], block["K8"],
                unit["K9"], unit["K10"], {
        "name": "gru_fit",
        "route": "cuda",
        "source": "src/repro_torch/csrc/gru_fit.cu",
        "replaces": "src/repro/core/rnn_predictor.py:57 (_compiled_fit, "
                    "jax.jit of fit at :93)",
        "launches": launches["K4"],
        "max_abs_err": k4["max_abs_err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": None,
        "chain_bound_ms": k4["chain_bound_ms"],
        "sm_clock_max_mhz": k4["sm_clock_max_mhz"],
        "bitwise_rows": k4["bitwise_rows"],
        "rows": k4["rows"],
        "forecast_next_ms": k4["forecast_next_ms"],
        "batch_ms": k4["batch_ms"],
        "batch_plain_ms": k4["batch_plain_ms"],
        "shape": "rows=1 n=60 steps=150 (batch: rows=120)"}]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
