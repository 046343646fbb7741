#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Drives the paper's delivery replay through the port's entry points, builds
every kernel on that path from the sources in this checkout and holds each
against its plain PyTorch version on the card.  Phases, in order (any
failure raises and the script exits non-zero):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
1. build the ARIMA bank kernel (K1) with ``nvcc``;
2. K1 against its plain version on synthetic gap series: forecasts within
   rtol 1e-3, NaN positions equal, rows bitwise independent of the launch;
3. ``hpm`` on the OOI trace at scale 1.0 (main path);
4. ``hpm`` on the ``ooi_arima`` profile at OOI's 400 users (main path):
   every deferred series of at least 4 gaps goes through K1; then, for the
   flushes of phases 3 and 4, K1 and its plain version on exactly those
   inputs, compared and timed with CUDA events;
5. ``cache_only`` on the phase 3 trace;
6. online == batched on the card: ``hpm`` on a small jittered trace gives
   identical counters through the vector engine (batched K1 launches) and
   the reference engine (one padded K1 group per prediction).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and dense
# float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

RTOL = 1e-3     # kernel vs plain: the Adam trajectory amplifies ulps
STEPS, LR = 200, 0.05


def log(*args) -> None:
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


def phase_k1_synthetic(torch, K, np, dev, time_ms) -> None:
    log("== phase 2: K1 vs plain on synthetic gap series")
    rng = np.random.default_rng(20261016)
    for n in (4, 8, 16, 32, 60):
        y = torch.from_numpy(rng.normal(3600.0, 400.0, size=(256, n))
                             .astype(np.float32)).to(dev)
        got = K.arima_bank(y, (2, 1, 1), STEPS, LR)
        want = K.arima_fit_plain(y, (2, 1, 1), STEPS, LR)
        _sync(dev)()
        cmp = compare(got, want)
        k_ms = time_ms(lambda: K.arima_bank(y, (2, 1, 1), STEPS, LR), reps=5)
        p_ms = time_ms(lambda: K.arima_fit_plain(y, (2, 1, 1), STEPS, LR),
                       reps=1, warmup=False)
        # rows are independent of the launch: alone, reversed, full batch
        rev = K.arima_bank(y.flip(0).contiguous(), (2, 1, 1), STEPS, LR)
        alone = torch.cat([K.arima_bank(y[i:i + 1].contiguous(), (2, 1, 1),
                                        STEPS, LR) for i in range(0, 256, 37)])
        bits = got.view(torch.int32)
        if not (torch.equal(bits, rev.flip(0).view(torch.int32))
                and torch.equal(bits[::37], alone.view(torch.int32))):
            raise AssertionError(f"K1 n={n}: rows depend on the launch")
        log(f"n={n:2d} rows=256 kernel_ms={k_ms:.3f} plain_ms={p_ms:.1f} "
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
    log(f"d=2 quadratic: kernel={float(got[0]):.6f} "
        f"plain={float(want[0]):.6f} numpy_extrapolation={expect:.6f} "
        f"max_abs_err={cmp['max_abs_err']:.6g}")


def record_calls(cls, name: str):
    """Wrap method ``name`` of ``cls`` to keep ``(self, first argument,
    seconds)`` of every call; returns the list and a function that
    restores the method.  Used on ``ARIMA.batched_forecast`` (the series
    the planner defers: the kernel's inputs) and ``HPMAdapter.plan``."""
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


def run_main_path(T, K, name, test, train, profile, dev, strategy="hpm"):
    cfg = T.SimConfig(stream_rate_bytes_per_s=profile.bytes_per_second_stream,
                      cache_bytes=128 << 30, chunk_seconds=3600.0
                      ).calibrate_origin(test)
    sync = _sync(dev)
    sync()
    K.reset_counts()                      # counts of this run only
    t0 = time.perf_counter()
    res = T.run_strategy(strategy, test, profile.grid, cfg, train,
                         device=dev)
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


def k1_on_flush(torch, np, K, T_arima, name, calls, rows_launched, dev,
                time_ms) -> dict:
    """Check that every deferred series of >= 4 gaps of one replay went
    through K1 (one row each, in groups of ``BANK_WIDTH``), then run K1 and
    its plain version on exactly those inputs: compare and time both."""
    series = [np.asarray(s, np.float32) for _, sl, _ in calls for s in sl]
    fitted = [s for s in series if s.size >= 4]
    model = calls[0][0]
    buckets: dict[int, list] = {}
    for s in fitted:
        n = model._bucket(s.size)
        buckets.setdefault(n, []).append(s[-n:])
    padded = sum(-(-len(v) // T_arima.BANK_WIDTH) * T_arima.BANK_WIDTH
                 for v in buckets.values())
    if rows_launched != padded:
        raise AssertionError(f"{name}: K1 rows {rows_launched} != {padded}")
    log(f"{name}: deferred_series={len(series)} "
        f"with_4_or_more_gaps={len(fitted)} K1_rows_padded={rows_launched} "
        f"buckets={ {n: len(v) for n, v in sorted(buckets.items())} }")
    o = model.order
    order = (o.p, o.d, o.q)
    rec = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
           "max_rel_err": 0.0, "bitwise_rows": 0, "rows": 0}
    work = []
    for n, rows in sorted(buckets.items()):
        y = torch.from_numpy(np.stack(rows)).to(dev)
        got = K.arima_bank(y, order, model.steps, model.lr)
        out = {}

        def plain():
            out["want"] = K.arima_fit_plain(y, order, model.steps, model.lr)

        plain_ms = time_ms(plain, reps=1, warmup=False)
        cmp = compare(got, out["want"])
        ms = time_ms(lambda: K.arima_bank(y, order, model.steps, model.lr),
                     reps=3)
        rec["ms"] += ms
        rec["plain_ms"] += plain_ms
        work.append(k1_work(len(rows), n, *order, steps=model.steps))
        for key in ("max_abs_err", "max_rel_err"):
            rec[key] = max(rec[key], cmp[key])
        rec["bitwise_rows"] += cmp["bitwise_rows"]
        rec["rows"] += cmp["rows"]
        log(f"{name} bucket n={n}: rows={len(rows)} kernel_ms={ms:.3f} "
            f"plain_ms={plain_ms:.1f} max_abs_err={cmp['max_abs_err']:.6g} "
            f"max_rel_err={cmp['max_rel_err']:.3g} "
            f"bitwise_equal_rows={cmp['bitwise_rows']}/{len(rows)}")
    rec["bound_ms"], rec["bound_by"] = bound_ms(work)
    log(f"{name} K1 over the flush: kernel_ms={rec['ms']:.3f} "
        f"plain_ms={rec['plain_ms']:.1f} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']})")
    return rec


def drive(torch, np, T, T_arima, K, dev, ooi_scale: float = 1.0,
          arima_users: int = 400, time_ms=cuda_ms) -> list:
    """Phases 2-6 on ``dev``; returns the ``kernels`` records."""
    phase_k1_synthetic(torch, K, np, dev, time_ms)
    seen, restore_bank = record_calls(T_arima.ARIMA, "batched_forecast")
    plans, restore_plan = record_calls(T.HPMAdapter, "plan")

    log(f"== phase 3: hpm on OOI, scale {ooi_scale}")
    t0 = time.perf_counter()
    ooi = T.make_trace("ooi", seed=0, scale=ooi_scale)
    cut = int(len(ooi) * 0.3)
    ooi_train, ooi_test = ooi[:cut], ooi[cut:]
    log(f"trace seconds={time.perf_counter() - t0:.2f} requests={len(ooi)}")
    _, launches3, rows3, dt3 = run_main_path(T, K, "ooi", ooi_test,
                                             ooi_train, T.OOI_PROFILE, dev)
    if launches3 == 0 or not seen:
        raise AssertionError("ooi hpm: K1 never ran")
    log_split("ooi hpm", dt3, plans, seen)
    flush3 = list(seen)

    log(f"== phase 4: hpm on ooi_arima, {arima_users} users")
    profile = dataclasses.replace(
        T.OOI_PROFILE, name="ooi_arima", n_users=arima_users,
        human_user_frac=0.25,
        type_volume_mix=(0.85, 0.05, 0.10), period_jitter_frac=0.06,
        duration=7 * 24 * 3600.0)
    t0 = time.perf_counter()
    tr = T.TraceGenerator(profile, seed=0).generate()
    cut = int(len(tr) * 0.3)
    train, test = tr[:cut], tr[cut:]
    log(f"trace seconds={time.perf_counter() - t0:.2f} requests={len(tr)}")
    seen.clear()
    plans.clear()
    _, launches4, rows4, dt4 = run_main_path(T, K, "ooi_arima", test, train,
                                             profile, dev)
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

    # the ooi_arima cell is the one whose flush fills the card; the OOI
    # cell's numbers ride along under the *_ooi keys
    return [{
        "name": "arima_bank",
        "route": "cuda",
        "source": "src/repro_torch/csrc/arima_bank.cu",
        "replaces": "src/repro/core/arima.py:181 (_compiled_bank, "
                    "jit(vmap(_build_fit)))",
        "launches": launches4,
        "max_abs_err": max(k3["max_abs_err"], k4["max_abs_err"]),
        "max_rel_err": max(k3["max_rel_err"], k4["max_rel_err"]),
        "bitwise_rows": k4["bitwise_rows"],
        "rows": k4["rows"],
        "ms": k4["ms"],
        "kernel_ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": None,
        "launches_ooi": launches3,
        "ms_ooi": k3["ms"],
        "plain_ms_ooi": k3["plain_ms"],
        "bound_ms_ooi": k3["bound_ms"],
    }]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc" / "arima_bank.cu").is_file():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    import repro_torch.core as T
    import repro_torch.core.arima as T_arima
    from repro_torch.kernels import arima_bank as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 0: device")
    smi = smi_line()
    log(smi)
    log(f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"device={torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()}")

    log("== phase 1: build K1")
    t0 = time.perf_counter()
    diag = K.build(verbose=True)
    log(f"K1 build seconds={time.perf_counter() - t0:.2f}")
    for line in diag.splitlines():
        if "registers" in line or "spill" in line or "stack" in line:
            log("ptxas:", line.strip())

    kernels = drive(torch, np, T, T_arima, K, torch.device("cuda"))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
