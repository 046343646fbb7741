#!/usr/bin/env python3
"""Time the ARIMA bank kernel (K1) of one or more source trees on one card.

Each ``--tree DIR`` (a checkout, or an unpacked ``git archive`` of one) is
measured in a child process of its own that imports ``repro_torch`` from
``DIR/src`` and builds K1 from ``DIR``'s sources; trees run in the order
given, so ``--tree old --tree new --tree new --tree old`` interleaves two
versions on one card.  The measurements are ``chip_smoke.py``'s own and
call only what every tree of the port has.  Per tree:

- the build's registers and spills (``-Xptxas -v``);
- per history length n in 4, 8, 16, 32, 60 at order (2, 1, 1):
  ``chip_smoke.k1_shape_times`` (the kernel on 256 rows and on one row,
  CUDA events; one online ``forecast_next`` end to end, host clock) and
  the rows of the 256-row call bitwise equal to the plain version;
- ``hpm`` on the ``ooi_arima`` trace at ``chip_smoke.ARIMA_USERS`` users,
  then that replay's bank flush: K1's launches and device time inside one
  ``ARIMA.batched_forecast`` of it (``torch.profiler``) and the call's
  host time;
- ``md2`` on the same profile at ``--md2-users`` users (0 skips it).

The last line is one JSON object with every tree's numbers.  Run from the
repository root on a machine with the card:

    python3 scripts/k1_compare.py --tree build/parent --tree . --md2-users 40
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = (4, 8, 16, 32, 60)
MARK = "k1_compare "


def measure(tree: Path, md2_users: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as S
    import repro_torch.core as T
    import repro_torch.core.arima as T_arima
    from repro_torch.kernels import arima_bank as K

    if not torch.cuda.is_available():
        raise SystemExit("k1_compare: no CUDA device")
    t0 = time.perf_counter()
    S.log_build("K1", K.start_build(verbose=True).wait(),
                time.perf_counter() - t0)
    dev = torch.device("cuda")
    rec: dict = {"tree": str(tree), "device": torch.cuda.get_device_name(0),
                 "shapes": {}}
    rng = np.random.default_rng(20261016)
    for n in BUCKETS:
        y = torch.from_numpy(rng.normal(3600.0, 400.0, size=(256, n))
                             .astype(np.float32)).to(dev)
        cmp = S.compare(K.arima_bank(y, (2, 1, 1), S.STEPS, S.LR),
                        K.arima_fit_plain(y, (2, 1, 1), S.STEPS, S.LR))
        ms256, ms1, call_ms = S.k1_shape_times(K, T_arima, y, dev, S.cuda_ms)
        rec["shapes"][n] = {"ms_256": ms256, "ms_1": ms1,
                            "forecast_next_ms": call_ms,
                            "bitwise_rows": cmp["bitwise_rows"]}
        S.log(f"n={n:2d} kernel_ms_256_rows={ms256:.4f} kernel_ms_1_row="
              f"{ms1:.4f} forecast_next_ms={call_ms:.4f} "
              f"bitwise_equal_rows={cmp['bitwise_rows']}/256")

    profile, train, test = S.ooi_arima_trace(T, S.ARIMA_USERS)
    seen, restore = S.record_calls(T_arima.ARIMA, "batched_forecast")
    try:
        S.run_main_path(T, K, "ooi_arima", test, train, profile, dev)
    finally:
        restore()
    model = seen[0][0]
    series = [np.asarray(s, np.float32) for _, sl, _ in seen for s in sl]
    model.batched_forecast(series)
    K.reset_counts()
    n_kernels, dev_ms = S.device_kernels(
        torch, lambda: model.batched_forecast(series), "arima")
    launches = K.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.batched_forecast(series)
    torch.cuda.synchronize()
    rec["flush"] = {"series": len(series), "launches": launches,
                    "profiled_kernels": n_kernels,
                    "profiled_device_ms": dev_ms,
                    "batched_forecast_ms": (time.perf_counter() - t0) * 1e3}
    S.log(f"flush: {rec['flush']}")
    if md2_users:
        profile, train, test = S.ooi_arima_trace(T, md2_users)
        rec["md2"] = S.run_md2(T, T_arima, K, f"ooi_arima {md2_users} users",
                               test, train, profile, dev)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", type=Path, default=[],
                    help="source tree to measure (repeatable, in order)")
    ap.add_argument("--md2-users", type=int, default=40)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        rec = measure(args.one.resolve(), args.md2_users)
        print(MARK + json.dumps(rec), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S
    smi = S.smi_line()
    print(smi, flush=True)
    results = []
    for tree in args.tree or [ROOT]:
        print(f"== tree {tree}", flush=True)
        proc = subprocess.run(
            [sys.executable, __file__, "--one", str(tree), "--md2-users",
             str(args.md2_users)], capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith(MARK):
                results.append(json.loads(line[len(MARK):]))
            else:
                print(line, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    print(smi, flush=True)
    print(json.dumps({"k1_compare": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
