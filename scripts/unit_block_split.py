#!/usr/bin/env python3
"""Split a dense layer's non-GEMM work at yi-6b's and mamba2-1.3b's training
shapes.

yi-6b (4 x 2048 tokens, d_model 4096, d_ff 11008, 32/4 heads of 128, bf16):
for each group of plain PyTorch ops below, one autograd forward and its
backward (random cotangents): device ms by ``torch.profiler`` and CUDA
events, kernels per group, and what a train step pays for it under the
default ``remat="nothing_saveable"``: layers x (two forwards, the second
the recompute, + one backward).  The groups:

- ``unit_norm_residual``: the unit's two ``rmsnorm`` calls and the two
  residual adds of a dense layer (``models/transformer.py``: before the
  mixer, after it, before the FFN, after it), written as the plain ops;
- ``swiglu_gate``: ``F.silu(g.float()).to(x.dtype) * u`` over d_ff;
- ``rope``: ``apply_rope`` of q and k;
- ``layer``: one whole dense layer (``_layer_forward``: projections,
  attention, the groups above) with its kernels summed by
  ``chip_smoke.op_class``; the rest is its device time outside the GEMMs,
  K2 and the groups above.

mamba2-1.3b (4 x 2048 tokens, d_model 2048, 48 layers): the unit's norm
and residual of a Mamba layer (one site: the layer has no FFN).

With ``--kernels`` the same groups also run through the port's fused
entries (``kernels.ops.add_rmsnorm``, ``kernels.ops.swiglu_gate``: K9 and
K10, on a checkout whose model runs them), and the layer's rest is taken
outside those.

Run on a machine with the card, from the repository root (about a
minute; it builds K2 and its backward first):

    python3 scripts/unit_block_split.py [--tree DIR] [--kernels]

``--tree`` names the checkout whose ``src`` is imported (default: this
one), so a parent and a change can be timed in one call.  The last line is
one JSON object with every number.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its timing and profiling helpers)

BATCH, SEQ = 4, 2048
YI_LAYERS, MAMBA_LAYERS = 32, 48


def by_class(table) -> dict:
    out: dict[str, float] = {}
    for e in table:
        k = chip_smoke.op_class(e.key)
        out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3
    return out


def group_times(torch, label, make, layers: int, reps: int = 5) -> dict:
    """``make()`` returns (inputs requiring grad, forward fn of them): the
    forward's and the forward+backward's ms (CUDA events) and device ms
    (``torch.profiler``), the kernels of each, and a train step's share:
    ``layers`` x (2 forwards + backward).  The backward's cotangents are
    made before the timed calls; the leaves' gradients are dropped after
    each."""
    leaves, fwd = make()

    def f():
        with torch.no_grad():
            return fwd(*leaves)

    # the cotangents are made once, outside the timed calls
    outs = f()
    grads = [torch.full_like(o, 1e-3) for o in
             (outs if isinstance(outs, tuple) else (outs,))]
    del outs

    def fb():
        outs = fwd(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.autograd.backward(outs, grads)
        for t in leaves:
            t.grad = None

    f_ms = chip_smoke.cuda_ms(f, reps)
    fb_ms = chip_smoke.cuda_ms(fb, reps)
    _, f_busy, f_n, _ = chip_smoke.profiled(torch, f, host=False)
    _, fb_busy, fb_n, table = chip_smoke.profiled(torch, fb, host=False)
    step = layers * (f_busy + fb_busy)
    print(f"{label}: forward_ms={f_ms:.4f} forward_backward_ms={fb_ms:.4f} "
          f"device_ms_forward={f_busy:.4f} device_ms_forward_backward="
          f"{fb_busy:.4f} kernels_forward={f_n} kernels_forward_backward="
          f"{fb_n} train_step_device_ms={step:.2f} train_step_kernels="
          f"{layers * (f_n + fb_n)} (x{layers} layers, forward twice)",
          flush=True)
    return {"forward_ms": f_ms, "forward_backward_ms": fb_ms,
            "device_ms_forward": f_busy, "device_ms_forward_backward": fb_busy,
            "kernels_forward": f_n, "kernels_forward_backward": fb_n,
            "train_step_device_ms": step,
            "train_step_kernels": layers * (f_n + fb_n),
            "by_class": by_class(table)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--kernels", action="store_true",
                    help="also time the groups through K9 and K10")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("unit_block_split: no CUDA device", file=sys.stderr)
        return 2
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.models.layers import apply_rope, rmsnorm
    from repro_torch.models.transformer import _layer_forward, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    builds = [K2.start_build(), K2.start_build_backward()]
    ops = None
    if args.kernels:
        from repro_torch.kernels import ops
        from repro_torch.kernels import swiglu_gate as K10
        from repro_torch.kernels import unit_norm as K9
        builds += [K9.start_build(), K10.start_build()]
    for b in builds:
        b.wait()
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(dtype).requires_grad_()

    print(chip_smoke.smi_line(), flush=True)
    out: dict = {"device": torch.cuda.get_device_name(0),
                 "power": chip_smoke.smi_line(), "tree": str(tree),
                 "yi-6b": {}, "mamba2-1.3b": {}}
    yi = get_config("yi-6b")
    d, f, a = yi.d_model, yi.d_ff, yi.attn
    tr = out["yi-6b"]

    def norms(fused: bool, sites: int, width: int):
        def make():
            ins = [rnd(BATCH, SEQ, width)] + \
                [rnd(BATCH, SEQ, width) for _ in range(sites)] + \
                [rnd(width, dtype=torch.float32) for _ in range(sites)]

            def fwd(x, *rest):
                hs, scales = rest[:sites], rest[sites:]
                ys = []
                for hh, sc in zip(hs, scales):
                    if fused:
                        x, y = ops.add_rmsnorm(x, hh, sc)
                    else:
                        y = rmsnorm(x, sc)
                        x = x + hh
                    ys.append(y)
                return (x, *ys)
            return ins, fwd
        return make

    def gate(fused: bool):
        def make():
            ins = [rnd(BATCH, SEQ, f), rnd(BATCH, SEQ, f)]

            def fwd(g, u):
                if fused:
                    return ops.swiglu_gate(g, u)
                return F.silu(g.float()).to(u.dtype) * u
            return ins, fwd
        return make

    def rope():
        ins = [rnd(BATCH, SEQ, a.n_heads, a.head_dim),
               rnd(BATCH, SEQ, a.n_kv_heads, a.head_dim)]
        pos = torch.arange(SEQ, device=dev)

        def fwd(q, k):
            return (apply_rope(q, pos, a.rope_theta),
                    apply_rope(k, pos, a.rope_theta))
        return ins, fwd

    tr["unit_norm_residual"] = group_times(
        torch, "yi-6b unit rmsnorm and residual (2 sites)",
        norms(False, 2, d), YI_LAYERS)
    tr["swiglu_gate"] = group_times(torch, "yi-6b SwiGLU gate", gate(False),
                                    YI_LAYERS)
    tr["rope"] = group_times(torch, "yi-6b rope of q and k", rope,
                             YI_LAYERS)
    if ops is not None:
        tr["k9_add_rmsnorm"] = group_times(
            torch, "yi-6b K9 add + rmsnorm (2 sites)", norms(True, 2, d),
            YI_LAYERS)
        tr["k10_swiglu_gate"] = group_times(torch, "yi-6b K10 SwiGLU gate",
                                            gate(True), YI_LAYERS)

    one = get_config("yi-6b")
    import dataclasses
    one = dataclasses.replace(one, n_layers=1)
    params = init_params(torch.Generator(device=dev).manual_seed(0), one,
                         dev)
    lp = params["units"][0][0]
    leaves = [t for t in (*lp["mixer"].values(), *lp["mlp"].values(),
                          lp["norm1"], lp["norm2"])]
    for t in leaves:
        t.requires_grad_()
    # the layer's signature: (p, cfg, spec, x, positions), or with the
    # pending branch output h before positions
    takes_h = "h" in inspect.signature(_layer_forward).parameters

    def layer():
        x = rnd(BATCH, SEQ, d)
        pos = torch.arange(SEQ, device=dev)

        def fwd(x, *_):
            if takes_h:
                s, h = _layer_forward(lp, one, one.pattern[0], x, None,
                                      pos)[:2]
                return s, h
            return _layer_forward(lp, one, one.pattern[0], x, pos)[0]
        return [x, *leaves], fwd
    tr["layer"] = group_times(torch, "one yi-6b layer (_layer_forward)",
                              layer, YI_LAYERS, reps=3)
    for t in leaves:
        t.requires_grad_(False)
        t.grad = None
    del params, lp, leaves
    lay = tr["layer"]["by_class"]
    # the groups as this checkout's layer runs them: K9 and K10 where the
    # fused entries are timed (a checkout whose model runs them), else
    # the plain ops
    groups = sum(tr[k]["device_ms_forward_backward"] for k in (
        ("k9_add_rmsnorm", "k10_swiglu_gate", "rope") if ops is not None
        else ("unit_norm_residual", "swiglu_gate", "rope")))
    non_gemm = sum(v for k, v in lay.items()
                   if k not in ("GEMMs", "K2 forward", "K2 backward"))
    tr["layer_non_gemm_ms"] = non_gemm
    tr["layer_rest_ms"] = non_gemm - groups
    print("one yi-6b layer forward+backward, device ms by class: "
          + " ".join(f"{k.replace(' ', '_')}={v:.3f}" for k, v in
                     sorted(lay.items()))
          + f"; outside GEMMs and K2 {non_gemm:.3f}; the three groups "
          f"{groups:.3f}; the rest {non_gemm - groups:.3f}; a step at 32 "
          f"layers pays the rest {YI_LAYERS * (non_gemm - groups):.2f} "
          f"(forward and backward once; the recompute's share not split)",
          flush=True)

    mb = get_config("mamba2-1.3b")
    out["mamba2-1.3b"]["unit_norm_residual"] = group_times(
        torch, "mamba2-1.3b unit rmsnorm and residual (1 site)",
        norms(False, 1, mb.d_model), MAMBA_LAYERS)
    if ops is not None:
        out["mamba2-1.3b"]["k9_add_rmsnorm"] = group_times(
            torch, "mamba2-1.3b K9 add + rmsnorm (1 site)",
            norms(True, 1, mb.d_model), MAMBA_LAYERS)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
