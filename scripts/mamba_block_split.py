#!/usr/bin/env python3
"""Split the Mamba block's plain elementwise work at mamba2-1.3b's shapes.

Training (4 x 2048 tokens, d_inner 4096, 64 heads of 64, N 128, bf16): for
each group of the block's plain PyTorch ops, one layer's autograd forward
and its backward (random cotangents) timed with CUDA events, its kernels
counted by ``torch.profiler``, and what a train step pays for it: 48
layers x (two forwards, the second the remat recompute, + one backward).
The groups:

- ``conv``: the three ``_causal_conv`` calls (xs, B, C) with their SiLU;
- ``dt``: dt's softplus and ``A = -exp(A_log)``;
- ``dskip_norm``: the D skip ``y + xs * D`` and ``_gated_norm``;
- ``unit_norm_residual``: the unit's ``rmsnorm`` before the mixer and the
  residual add after it (``models/transformer.py`` ``_layer_forward``);
- ``layer``: the whole ``_layer_forward`` of one Mamba layer (projections,
  K3 forward and backward, everything above); its kernels by
  ``chip_smoke.op_class``; ``other`` is its device time outside the GEMMs,
  K3 and the groups above.

Decode (one token, batch 1): the kernels one eager ``decode_step`` of the
full 48-layer model launches, and those of each group of one layer's
``mamba_decode`` traced alone (projections, convs, dt, the state step, the
gated norm, the output projection, the unit's norm and residual, and the
decode program's copies of the new states into its buffers).

Run on a machine with the card, from the repository root (about a
minute; it builds K3 and its backward first):

    python3 scripts/mamba_block_split.py

The last line is one JSON object with every number.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402  (its timing and profiling helpers)

BATCH, SEQ, LAYERS = 4, 2048, 48


def kernels_of(torch, fn) -> tuple[int, float, dict]:
    """Kernels one call of ``fn`` launches, their device ms, and device ms
    by ``chip_smoke.op_class``."""
    _, busy, n, table = chip_smoke.profiled(torch, fn, host=False)
    by: dict[str, float] = {}
    for e in table:
        k = chip_smoke.op_class(e.key)
        by[k] = by.get(k, 0.0) + e.self_device_time_total / 1e3
    return n, busy, by


def group_times(torch, label, make, reps=5) -> dict:
    """``make()`` returns (inputs requiring grad, forward fn of them): the
    forward's ms, the forward+backward's ms, the kernels of each, and a
    train step's share (LAYERS x (2 forwards + backward))."""
    leaves, fwd = make()

    def f():
        with torch.no_grad():
            fwd(*leaves)

    def fb():
        outs = fwd(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        grads = [torch.ones_like(o) * 1e-3 for o in outs]
        torch.autograd.backward(outs, grads)
        for t in leaves:
            t.grad = None

    f_ms = chip_smoke.cuda_ms(f, reps)
    fb_ms = chip_smoke.cuda_ms(fb, reps)
    f_n, _, _ = kernels_of(torch, f)
    fb_n, fb_busy, by = kernels_of(torch, fb)
    step = LAYERS * (f_ms + fb_ms)
    print(f"{label}: forward_ms={f_ms:.4f} forward_backward_ms={fb_ms:.4f} "
          f"kernels_forward={f_n} kernels_forward_backward={fb_n} "
          f"train_step_ms={step:.2f} (x{LAYERS} layers, forward twice)",
          flush=True)
    return {"forward_ms": f_ms, "forward_backward_ms": fb_ms,
            "kernels_forward": f_n, "kernels_forward_backward": fb_n,
            "train_step_ms": step, "train_step_kernels":
            LAYERS * (f_n + fb_n), "by_class": by}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mamba_block_split: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.models import mamba as M
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import (_layer_forward, decode_step,
                                                init_params, prefill)

    torch.backends.cuda.matmul.allow_tf32 = False
    builds = [K3.start_build(), K3.start_build_backward()]
    for b in builds:
        b.wait()
    dev = torch.device("cuda")
    cfg = get_config("mamba2-1.3b")
    m = cfg.mamba
    di, h, p, n, g = m.d_inner, m.n_heads, m.head_dim, m.d_state, m.n_groups
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(dtype).requires_grad_()

    print(chip_smoke.smi_line(), flush=True)
    out: dict = {"device": torch.cuda.get_device_name(0),
                 "power": chip_smoke.smi_line(), "train": {}, "decode": {}}
    tr = out["train"]

    def conv():
        ins = [rnd(BATCH, SEQ, di), rnd(BATCH, SEQ, g * n),
               rnd(BATCH, SEQ, g * n), rnd(m.d_conv, di, scale=0.1),
               rnd(m.d_conv, g * n, scale=0.1), rnd(m.d_conv, g * n,
                                                    scale=0.1),
               rnd(di, scale=0.1), rnd(g * n, scale=0.1),
               rnd(g * n, scale=0.1)]

        def fwd(x, b_, c_, wx, wb, wc, bx, bb, bc):
            return (M._causal_conv(x, wx, bx)[0], M._causal_conv(b_, wb, bb)[0],
                    M._causal_conv(c_, wc, bc)[0])
        return ins, fwd
    tr["conv"] = group_times(torch, "conv (3 _causal_conv)", conv)

    def dt():
        ins = [rnd(BATCH, SEQ, h), rnd(h, dtype=torch.float32),
               rnd(h, dtype=torch.float32)]

        def fwd(d, bias, a_log):
            return F.softplus(d.float() + bias), -torch.exp(a_log)
        return ins, fwd
    tr["dt"] = group_times(torch, "dt softplus and A", dt)

    def dskip_norm():
        ins = [rnd(BATCH, SEQ, h, p), rnd(BATCH, SEQ, h, p),
               rnd(BATCH, SEQ, di), rnd(h, dtype=torch.float32),
               rnd(di, dtype=torch.float32)]

        def fwd(y, xs, z, d, scale):
            y = y + xs * d[None, None, :, None].to(xs.dtype)
            return M._gated_norm(y.reshape(BATCH, SEQ, di), z, scale)
        return ins, fwd
    tr["dskip_norm"] = group_times(torch, "D skip and _gated_norm",
                                   dskip_norm)

    def unit():
        ins = [rnd(BATCH, SEQ, cfg.d_model), rnd(BATCH, SEQ, cfg.d_model),
               rnd(cfg.d_model, dtype=torch.float32)]

        def fwd(x, hh, scale):
            return rmsnorm(x, scale), x + hh
        return ins, fwd
    tr["unit_norm_residual"] = group_times(
        torch, "unit rmsnorm and residual", unit)

    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    lp = params["units"][0][0]
    for t in lp["mixer"].values():
        t.requires_grad_()

    def layer():
        x = rnd(BATCH, SEQ, cfg.d_model)
        pos = torch.arange(SEQ, device=dev)

        def fwd(x, *mixer):
            return _layer_forward(lp, cfg, cfg.pattern[0], x, pos)[0]
        return [x, *lp["mixer"].values()], fwd
    tr["layer"] = group_times(torch, "one Mamba layer (_layer_forward)",
                              layer, reps=3)
    for t in lp["mixer"].values():
        t.requires_grad_(False)
        t.grad = None
    lay = tr["layer"]["by_class"]
    groups = sum(tr[k]["forward_backward_ms"]
                 for k in ("conv", "dt", "dskip_norm", "unit_norm_residual"))
    other = lay.get("other", 0.0)
    tr["layer_other_ms"] = other
    tr["layer_other_outside_groups_ms"] = other - groups
    print(f"one layer forward+backward, device ms by class: "
          + " ".join(f"{k.replace(' ', '_')}={v:.3f}" for k, v in
                     sorted(lay.items()))
          + f"; the four groups' forward+backward {groups:.3f}; other "
          f"outside them {other - groups:.3f}", flush=True)

    # decode: one token of the whole model, then each group of one layer
    tokens = torch.arange(64, device=dev)[None] % cfg.vocab
    with torch.no_grad():
        logits, caches, length = prefill(params, cfg, tokens, None,
                                         max_len=80)
        tok = logits.argmax(-1)
        pos = torch.tensor(length, device=dev)
        n_tok, busy_tok, by_tok = kernels_of(
            torch, lambda: decode_step(params, cfg, tok, caches, pos))
        dec = out["decode"]
        dec["token"] = {"kernels": n_tok, "device_ms": busy_tok,
                        "by_class": by_tok}
        print(f"decode token (eager decode_step, {cfg.n_layers} layers): "
              f"kernels={n_tok} device_ms={busy_tok:.3f}", flush=True)
        mp, cache = lp["mixer"], caches["units"][0][0]
        x = torch.randn(1, 1, cfg.d_model, device=dev).to(bf)
        z, xs, bm, cm, dtr = M._project(mp, x)
        xs1, _ = M._causal_conv(xs, mp["conv_x_w"], mp["conv_x_b"],
                                cache["conv"]["x"])
        y = torch.randn(1, h, p, device=dev).to(bf)
        new = {"ssm": cache["ssm"].clone(),
               "conv": {k: v.clone() for k, v in cache["conv"].items()}}

        def state_step():
            xs_ = xs1.reshape(1, h, p)
            dtv = F.softplus(dtr.float() + mp["dt_bias"])[:, 0]
            dA = torch.exp(dtv * (-torch.exp(mp["A_log"]))[None, :])
            rep = h // g
            bh = torch.repeat_interleave(bm.reshape(1, g, n), rep, dim=1)
            ch = torch.repeat_interleave(cm.reshape(1, g, n), rep, dim=1)
            s_new = (cache["ssm"] * dA[..., None, None] + torch.einsum(
                "bhn,bh,bhp->bhnp", bh.float(), dtv, xs_.float()))
            yy = torch.einsum("bhn,bhnp->bhp", ch, s_new.to(bf))
            return yy + xs_ * mp["D"][None, :, None].to(bf)

        def copies():
            for buf, src in ((new["ssm"], cache["ssm"]),
                             *((new["conv"][k], cache["conv"][k])
                               for k in ("x", "B", "C"))):
                buf.copy_(src)
        parts = {
            "project": lambda: M._project(mp, x),
            "conv": lambda: [M._causal_conv(
                t, mp[f"conv_{k}_w"], mp[f"conv_{k}_b"], cache["conv"][k])
                for t, k in ((xs, "x"), (bm, "B"), (cm, "C"))],
            "dt_A": lambda: (F.softplus(dtr.float() + mp["dt_bias"]),
                             -torch.exp(mp["A_log"])),
            "state_step_dskip": state_step,
            "gated_norm": lambda: M._gated_norm(
                y.reshape(1, 1, di).to(bf), z, mp["norm_scale"]),
            "out_proj": lambda: y.reshape(1, 1, di) @ mp["out_proj"],
            "unit_norm_residual": lambda: (rmsnorm(x, lp["norm1"]), x + x),
            "program_state_copies": copies,
        }
        dec["layer_parts"] = {}
        for name, fn in parts.items():
            k, ms, _ = kernels_of(torch, fn)
            dec["layer_parts"][name] = {"kernels": k, "device_ms": ms}
            print(f"decode, one layer, {name}: kernels={k} "
                  f"device_ms={ms:.4f}", flush=True)
        per_layer = sum(v["kernels"] for v in dec["layer_parts"].values())
        print(f"decode, one layer: {per_layer} kernels by part; the token "
              f"{n_tok} over {cfg.n_layers} layers = "
              f"{n_tok / cfg.n_layers:.1f} a layer", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
