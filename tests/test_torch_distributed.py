"""The port's multi-device layer: compression, elastic policy and
straggler monitor against ``repro``'s, then spawned gloo process groups on
the CPU (world sizes 2 and 4, and 1 for a restore) holding the sharded
paths against the port's single-device ones:

- one float32 train step of reduced yi-6b, mamba2-1.3b and deepseek-v3 on
  (2, 1), (1, 2) and (2, 2) meshes against the single-device step: loss
  within rtol 1e-5, gradient norm within rtol 1e-4, per tensor both AdamW
  moments within 1e-4 relative L2 (they are the gradients' own
  precision), the parameters exactly AdamW's first step from the mesh's
  own moments (bias corrections and weight decay on sharded leaves),
  and each parameter's update (new minus old) within 1e-2 relative L2 of
  the single-device one.  That last bound is loose because AdamW's first
  step moves an element by lr·g/(|g|+eps): where |g| is near eps (seen:
  one element of reduced yi-6b's ``w_k`` at 5e-9) a last-bit difference
  in g moves it by another amount, up to 3e-3 of the leaf's update; a
  skipped, halved or reversed update reads 0.5 or more.  With data
  parallelism (dp > 1) an MoE is not the single-device function, as in
  ``repro``: capacity and the aux loss are per data shard; there the
  single-device step takes one microbatch per data shard, which is that
  function;
- the MoE's fallback, where a batch of one does not divide the data axis,
  in train and serve mode at (2, 2): output and float32 gradients
  against ``moe_apply``, and the experts kept split (an all-gather of one
  ``model`` rank's share in train mode, none in serve);
- the gradients of every parameter in float32 at rtol 1e-4 (relative L2)
  against the single-device ones: deepseek-v3 at (1, 2), mamba2-1.3b at
  (2, 1), yi-6b at (2, 2);
- ``moe_apply_ep`` against ``moe_apply`` in train and serve mode at
  (2, 2), at ``repro``'s tolerances (``tests/test_multidevice.py``: atol
  2e-5, rtol 1e-4; aux within 15%);
- the int8 compressed all-reduce over a 2-pod (2, 1, 2) mesh against the
  true sum at atol 8e-2 (``repro``'s);
- a checkpoint saved at world size 2 and restored at 4 and at 1, bitwise;
- a float32 reduced prefill under ``serve`` placements at (1, 2), through
  ``kernels/ops.py``'s ``local_map`` path on the plain versions, against
  the unsharded prefill at atol 1e-5, rtol 1e-4;
- the in-place sharded step (``make_train_step(...).in_place``: AdamW on
  each rank's local shards, the norm's sum all-reduced across ranks)
  against the functional step of K5's plain version on the DTensors
  themselves, from non-zero moments: bit for bit where the norm is under
  the clip, within relative L2 1e-6 where it clips (the two norms sum in
  other orders); its norm within 1e-6 of the norm of the same gradients
  gathered onto one device; with 2 microbatches too;
- ``adamw_update_`` on a hand-placed set (sharded, replicated, uneven and
  empty shards, a bf16 tensor) against ``adamw_update_`` on the whole
  tensors on one device: the norm within 1e-6 (a replicated tensor counts
  once), bit for bit unclipped, relative L2 1e-6 clipped; ``adamw_update``
  on DTensors bit for bit with it; every copy of a replicated shard equal
  across ranks; a NaN partial loss on one rank, or a NaN in one rank's
  shard, skips the step on every rank; a ``Partial`` gradient raises;
- a checkpoint saved before an in-place step restores the values it
  saved; ``TrainProgram`` takes a mesh; ``train_loop(..., mesh=)``
  steps through ``in_place`` (the functional update is never called),
  bit for bit with the functional step;
- the Mamba block's conv (K6's plain version per rank, every segment's
  channels split over ``model``) and gated norm (K7's, its row split over
  ``model`` with the sums of squares all-reduced between its passes) at
  (1, 2) and (2, 2): outputs and gradients within 1e-6 / 1e-5 relative L2
  of the single-device plain versions, the split plain backward within
  1e-6 on a rank's share of the rows;
- at world sizes 1 and 2, ``train_loop(..., mesh=)``'s initial state bit
  for bit the whole seed-0 init placed, every local tensor owning its
  storage, no whole sharded leaf alive past its placement; the sharded
  init of every reduced config bit for bit its whole init placed;
  ``TrainProgram`` on the gloo mesh bit for bit ``step_fn.in_place``
  with 1 and 2 microbatches; a resume bit for bit.

Each group is one set of processes on a ``FileStore`` of its own under
the test's temporary directory, with its own timeout; the groups at world
sizes 2 and 4 run at once.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.compression as JC
import repro.distributed.elastic as JE
import repro_torch.distributed.compression as TC
import repro_torch.distributed.elastic as TE

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
TRAIN_ARCHS = ("yi-6b", "mamba2-1.3b", "deepseek-v3-671b")


@pytest.mark.parametrize("shape", [(7,), (256,), (3, 300), (2, 5, 129)])
def test_quantize_and_feedback_match_repro(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10)).astype(
        np.float32)
    res = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    q, scale = TC.quantize_int8(torch.from_numpy(x))
    jq, jscale = JC.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    deq = TC.dequantize_int8(q, scale, shape, torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(JC.dequantize_int8(jq, jscale, shape,
                                                   jnp.float32)))
    out, new_res = TC.compress_with_feedback(torch.from_numpy(x),
                                             torch.from_numpy(res))
    jout, jres = JC.compress_with_feedback(jnp.asarray(x), jnp.asarray(res))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(new_res.numpy(), np.asarray(jres))
    # each block's error is within half its scale
    err = (torch.from_numpy(x).reshape(-1) - deq.reshape(-1))
    pad = (-err.numel()) % TC.BLOCK
    err = torch.nn.functional.pad(err, (0, pad)).reshape(-1, TC.BLOCK)
    assert bool((err.abs() <= scale / 2 + 1e-12).all())


@pytest.mark.parametrize("want_pods", [False, True])
@pytest.mark.parametrize("model_parallel", [1, 2, 8, 16])
def test_largest_mesh_shape_matches_repro(want_pods, model_parallel):
    for n in range(1, 1025):
        assert TE.largest_mesh_shape(n, model_parallel, want_pods) == \
            JE.largest_mesh_shape(n, model_parallel, want_pods), n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_matches_repro(seed):
    rng = np.random.default_rng(seed)
    kw = dict(threshold=1.3, patience=4, window=20)
    ours, theirs = TE.StragglerMonitor(**kw), JE.StragglerMonitor(**kw)
    slow = int(rng.integers(0, 6))
    for step in range(60):
        for host in range(6):
            t = float(rng.uniform(0.9, 1.1))
            if host == slow and step > 30:
                t *= 1.6
            ours.record(host, t)
            theirs.record(host, t)
        assert ours.stragglers() == theirs.stragglers()
    assert ours.stragglers() == [slow]


_WORKER = r"""
import contextlib, dataclasses, json, os, sys
from datetime import timedelta
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
tmp, group = os.environ["TMPDIR_CASES"], os.environ["GROUP"]
dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{group}",
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=300))
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from repro_torch.configs import get_reduced_config
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shardings import distribute, param_shardings
from repro_torch.models.transformer import init_params, prefill
from repro_torch.train.loop import TrainConfig, make_train_step, place_state
from repro_torch.train.optimizer import adamw_init

out = {}
AXES2 = ("data", "model")


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def train_case(arch, shape):
    from repro_torch.models.transformer import loss_fn
    from repro_torch.train.optimizer import _decays
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32)
    tcfg = TrainConfig()
    ocfg = tcfg.optimizer
    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    o = adamw_init(p, ocfg)
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (4, 32), generator=g)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    # an MoE's capacity and aux loss are per data shard: the same
    # function on one device is one microbatch per shard
    dp = shape[0] if cfg.moe else 1
    ref = make_train_step(cfg, TrainConfig(microbatches=dp))(p, o, batch)
    with torch.no_grad():
        ref_loss = sum(float(loss_fn(p, cfg, {k: v.chunk(dp)[i] for k, v in
                                              batch.items()})[1]["loss"])
                       for i in range(dp)) / dp
    mesh = make_mesh(shape, AXES2, "cpu")
    pd, od = place_state(cfg, p, o, mesh)
    new_p, new_o, m = make_train_step(cfg, tcfg, mesh)(pd, od, batch)
    old = pytree.tree_flatten_with_path(p)[0]
    new = [full(t) for t in pytree.tree_leaves(new_p)]
    mom = {k: [full(t) for t in pytree.tree_leaves(new_o[k])]
           for k in ("m", "v")}
    update = max(rel_l2(a - p0, b - p0) for a, b, (_, p0) in zip(
        new, pytree.tree_leaves(ref[0]), old))
    moments = {k: max(rel_l2(a, b) for a, b in zip(
        mom[k], pytree.tree_leaves(ref[1][k]))) for k in ("m", "v")}
    # the mesh's parameters are AdamW's first step from the mesh's own
    # moments: bias-corrected, with weight decay where the rule says
    t = torch.ones((), dtype=torch.float32)
    c1, c2 = 1 - ocfg.b1 ** t, 1 - ocfg.b2 ** t
    applied = 0.0
    for a, mm, vv, (path, p0) in zip(new, mom["m"], mom["v"], old):
        delta = (mm / c1) / (torch.sqrt(vv / c2) + ocfg.eps)
        if _decays(path, p0):
            delta = delta + ocfg.weight_decay * p0
        want = p0 - ocfg.lr * delta          # float32, as the step rounds
        applied = max(applied, rel_l2(a - p0, want - p0))
    placed = sum(isinstance(t, DTensor) for t in pytree.tree_leaves(
        (new_p, new_o["m"], new_o["v"])))
    out[f"train|{arch}|{shape}"] = {
        "loss": float(m["loss"]), "ref_loss": ref_loss,
        "grad_norm": float(m["grad_norm"]),
        "ref_grad_norm": float(ref[2]["grad_norm"]),
        "update_rel_l2": update, "m_rel_l2": moments["m"],
        "v_rel_l2": moments["v"], "applied_rel_l2": applied,
        "step": int(full(new_o["step"])),
        "all_dtensor": placed == 3 * len(old)}


def grad_case(arch, shape):
    from repro_torch.train.loop import _value_and_grad, place_batch
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32)
    tcfg = TrainConfig()
    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    o = adamw_init(p, tcfg.optimizer)
    tok = torch.randint(0, cfg.vocab, (4, 32),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    leaves, spec = pytree.tree_flatten(p)
    _, _, ref = _value_and_grad(leaves, spec, cfg, batch)
    mesh = make_mesh(shape, AXES2, "cpu")
    pd, _ = place_state(cfg, p, o, mesh)
    dl, dspec = pytree.tree_flatten(pd)
    _, _, got = _value_and_grad(dl, dspec, cfg, place_batch(batch, mesh))
    worst = max(float((full(a) - b).norm() / b.norm().clamp(min=1e-30))
                for a, b in zip(got, ref))
    out[f"grad|{arch}|{shape}"] = {"worst_rel_l2": worst}


def moe_case():
    from repro_torch.models.moe import (MoEConfig, make_moe_params,
                                        moe_apply, moe_apply_ep)
    cfg = MoEConfig(d_model=32, n_experts=8, top_k=2, d_ff_expert=16,
                    capacity_factor=8.0)
    p = make_moe_params(torch.Generator().manual_seed(0), cfg,
                        torch.float32)
    x = torch.randn((4, 8, 32), generator=torch.Generator().manual_seed(1))
    ref, aux_ref = moe_apply(p, cfg, x)
    mesh = make_mesh((2, 2), AXES2, "cpu")
    for mode in ("train", "serve"):
        pd = {k: distribute_tensor(v, mesh, list(pl)) for k, (v, pl) in
              zip(p, ((p[k], pl) for k, pl in zip(p, pytree.tree_leaves(
                  param_shardings({"mlp": p}, mesh, mode)["mlp"],
                  is_leaf=lambda t: isinstance(t, tuple)))))}
        y, aux = moe_apply_ep(pd, cfg, x, mesh, ("data",), mode)
        y = full(y)
        out[f"moe|{mode}"] = {
            "max_abs": float((y - ref).abs().max()),
            "ok": bool(torch.allclose(y, ref, atol=2e-5, rtol=1e-4)),
            "aux": float(full(aux)), "aux_ref": float(aux_ref),
            "weights_placed": str(pd["w_gate"].placements)}


def moe_fallback_case():
    # a batch of one on the (2, 2) mesh does not divide the data axis:
    # moe_apply takes the plain dispatch on the experts as they are split
    # over model.  Output, aux and float32 gradients against the plain
    # layer; the all-gathers must not bring every expert to every rank
    from repro_torch.launch.ctx import sharding_hints
    from repro_torch.launch.shardings import distribute
    from repro_torch.models.moe import MoEConfig, make_moe_params, moe_apply
    from repro_torch.roofline.analysis import collective_bytes
    cfg = MoEConfig(d_model=32, n_experts=8, top_k=2, d_ff_expert=16,
                    capacity_factor=8.0, n_shared_experts=1, d_ff_shared=16)
    p = make_moe_params(torch.Generator().manual_seed(0), cfg,
                        torch.float32)
    x = torch.randn((1, 8, 32), generator=torch.Generator().manual_seed(1))
    w = torch.randn((1, 8, 32), generator=torch.Generator().manual_seed(2))

    def run(params, xin, coll=None):
        leaves, spec = pytree.tree_flatten(params)
        live = [t.detach().requires_grad_() for t in (xin, *leaves)]
        with coll or contextlib.nullcontext():
            y, aux = moe_apply(pytree.tree_unflatten(live[1:], spec), cfg,
                               live[0])
        wt = w if not isinstance(y, DTensor) else distribute_tensor(
            w, y.device_mesh, [Replicate()] * y.device_mesh.ndim)
        grads = torch.autograd.grad((y * wt).sum() + aux, live)
        return full(y), full(aux), [full(g) for g in grads]

    ref, aux_ref, g_ref = run(p, x)
    mesh = make_mesh((2, 2), AXES2, "cpu")
    expert_bytes = sum(p[k].numel() * 4 for k in ("w_gate", "w_up",
                                                 "w_down"))
    for mode in ("train", "serve"):
        pd = distribute({"mlp": p}, mesh,
                        param_shardings({"mlp": p}, mesh, mode))["mlp"]
        xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        coll = collective_bytes()
        with sharding_hints(moe_mode=mode):
            y, aux, grads = run(pd, xd, coll)
        out[f"moe_fallback|{mode}"] = {
            "ok": bool(torch.allclose(y, ref, atol=2e-5, rtol=1e-4)),
            "max_abs": float((y - ref).abs().max()),
            "aux": float(aux), "aux_ref": float(aux_ref),
            "grad_rel_l2": max(rel_l2(a, b) for a, b in zip(grads, g_ref)),
            "gathered": coll.bytes["all-gather"],
            "expert_bytes": expert_bytes}


def compression_case():
    import numpy as np
    from repro_torch.distributed.compression import compressed_all_reduce
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")
    g_np = np.random.default_rng(0).normal(0, 1, (2, 64)).astype(
        np.float32)
    from repro_torch.distributed.compression import make_crosspod_grad_sync
    from repro_torch.roofline.analysis import collective_bytes
    pod = mesh.get_local_rank("pod")
    with collective_bytes() as coll:
        got = compressed_all_reduce(torch.from_numpy(g_np[pod]),
                                    mesh.get_group("pod"))
    want = g_np.sum(axis=0)
    grads = {"a": torch.from_numpy(g_np[pod]),
             "b": torch.from_numpy(g_np[pod][::-1].copy())}
    mean = {"a": g_np.mean(axis=0), "b": g_np[:, ::-1].mean(axis=0)}
    errs = {}
    for compress in (True, False):
        synced = make_crosspod_grad_sync(mesh, compress)(grads)
        errs[compress] = max(float(np.abs(synced[k].numpy() - mean[k]).max())
                             for k in grads)
    out[f"compress|rank{rank}"] = {
        "max_abs": float(np.abs(got.numpy() - want).max()),
        # one bf16 all-reduce of the 256-padded payload, c10d's in place
        "counted": coll.bytes["all-reduce"] == 256 * 2
        and coll.calls["all-reduce"] == 1,
        "sync_compressed": errs[True], "sync_plain": errs[False]}


def checkpoint_tree(mesh_shape):
    cfg = get_reduced_config("yi-6b")
    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    o = adamw_init(p, TrainConfig().optimizer)
    o["step"] = o["step"] + 7
    o["m"] = pytree.tree_map(lambda t: t + 0.25, o["m"])
    mesh = make_mesh(mesh_shape, AXES2, "cpu")
    return cfg, (p, o), place_state(cfg, p, o, mesh)


def checkpoint_save():
    _, _, placed = checkpoint_tree((2, 1))
    CheckpointManager(f"{tmp}/ckpt").save(placed, 3, blocking=True)


def checkpoint_restore(mesh_shape):
    _, plain, template = checkpoint_tree(mesh_shape)
    zeros = pytree.tree_map(
        lambda t: t * 0 if t.is_floating_point() else t, template)
    got = CheckpointManager(f"{tmp}/ckpt").restore(zeros, 3)
    same = all(torch.equal(full(a), b) and
               (not isinstance(c, DTensor) or a.placements == c.placements)
               for a, b, c in zip(pytree.tree_leaves(got),
                                  pytree.tree_leaves(plain),
                                  pytree.tree_leaves(template)))
    out[f"restore|{mesh_shape}"] = {"bitwise": same}


def prefill_case(arch):
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32)
    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.randint(0, cfg.vocab, (2, 24),
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref, ref_caches, _ = prefill(p, cfg, tok)
    mesh = make_mesh((1, 2), AXES2, "cpu")
    pd = distribute(p, mesh, param_shardings(p, mesh, "serve", cfg))
    import repro_torch.kernels.ops as ops
    calls = {"n": 0}
    orig = ops.per_rank

    def counted(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)
    ops.per_rank = counted
    try:
        with torch.no_grad():
            got, caches, _ = prefill(pd, cfg, tok)
    finally:
        ops.per_rank = orig
    got = full(got)
    cache_ok = all(torch.allclose(full(a), b, atol=1e-5, rtol=1e-4)
                   for a, b in zip(pytree.tree_leaves(caches),
                                   pytree.tree_leaves(ref_caches)))
    out[f"prefill|{arch}"] = {
        "max_abs": float((got - ref).abs().max()),
        "ok": bool(torch.allclose(got, ref, atol=1e-5, rtol=1e-4)),
        "caches_ok": cache_ok, "per_rank_calls": calls["n"]}


def bits_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def sets_rel_l2(got, want):
    num = sum(float((a.double() - b.double()).norm()) ** 2
              for a, b in zip(got, want))
    den = sum(float(b.double().norm()) ** 2 for b in want)
    return (num / max(den, 1e-300)) ** 0.5


def placed(cfg, p, o, mesh):
    # a replicated placement shares its input's storage, which an in-place
    # step would write: place copies
    return place_state(cfg, *pytree.tree_map(torch.clone, (p, o)), mesh)


def inplace_case(arch, shape, micro):
    # in place on local shards against K5's plain version on DTensors
    from repro_torch.kernels import adamw as K5
    from repro_torch.train import optimizer as TO
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32)
    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.randint(0, cfg.vocab, (4, 32),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    mesh = make_mesh(shape, AXES2, "cpu")
    for clip, name in ((1e9, "unclipped"), (1e-3, "clipped")):
        tcfg = TrainConfig(microbatches=micro,
                           optimizer=TO.AdamWConfig(grad_clip=clip))
        o = adamw_init(p, tcfg.optimizer)
        o["step"] = o["step"] + 7
        o["m"] = pytree.tree_map(lambda t: t + 1e-3, o["m"])
        o["v"] = pytree.tree_map(lambda t: t + 1e-6, o["v"])
        step = make_train_step(cfg, tcfg, mesh)
        # the functional step of K5's plain version on the DTensors
        pd, od = placed(cfg, p, o, mesh)
        loss, _, grads = step.gradients(pd, batch)
        gs, ps, ms, vs, decays, _ = TO._flat(grads, od, pd)
        dst = ([torch.empty_like(t) for t in ps],
               [torch.empty_like(t) for t in ms],
               [torch.empty_like(t) for t in vs],
               torch.empty_like(od["step"]))
        K5.adamw_step_plain_(gs, ps, ms, vs, od["step"], decays, loss=loss,
                             out=dst, **TO._hyper(tcfg.optimizer))
        want = [[full(t) for t in ls] for ls in dst[:3]]
        want_step = int(full(dst[3]))
        one_device = float(K5.grad_norm([full(g) for g in gs]))
        del grads, gs, dst
        # in place on each rank's local shards
        pd, od = placed(cfg, p, o, mesh)
        ptrs = [t.to_local().data_ptr() for t in pytree.tree_leaves((pd, od))]
        m = step.in_place(pd, od, batch)
        kept = ptrs == [t.to_local().data_ptr()
                        for t in pytree.tree_leaves((pd, od))]
        got = [[full(t) for t in pytree.tree_leaves(x)]
               for x in (pd, od["m"], od["v"])]
        res = {"bitwise": all(bits_equal(a, b) for ga, wa in zip(got, want)
                              for a, b in zip(ga, wa)),
               "rel_l2": {k: sets_rel_l2(ga, wa)
                          for k, ga, wa in zip("pmv", got, want)},
               "step": int(full(od["step"])), "want_step": want_step,
               "norm": float(m["grad_norm"]), "one_device_norm": one_device,
               "clipped": one_device > clip, "pointers_kept": kept,
               "all_dtensor": all(isinstance(t, DTensor)
                                  for t in pytree.tree_leaves((pd, od)))}
        if micro > 1:
            # the functional step (K5 on local shards, out of place)
            pf, of = placed(cfg, p, o, mesh)
            fp, fo, fm = step(pf, of, batch)
            res["functional_bitwise"] = all(
                bits_equal(full(a), b) for a, b in zip(
                    pytree.tree_leaves((fp, fo["m"], fo["v"])),
                    [t for ls in got for t in ls])) and torch.equal(
                fm["grad_norm"], m["grad_norm"])
        out[f"inplace|{arch}|{shape}|{micro}|{name}"] = res


def shards_case():
    # adamw_update_ on a hand-placed set against the whole tensors
    import numpy as np
    from torch.distributed.tensor import Partial, Shard
    from repro_torch.train import optimizer as TO
    mesh = make_mesh((2, world // 2), AXES2, "cpu")
    S0, S1, R = Shard(0), Shard(1), Replicate()
    # uneven over data; over model only at (2, 2); replicated; a bf16
    # tensor over both axes; dim 0 of 3 over both axes (an empty shard)
    spec = {"a": ((5, 3), [S0, R], torch.float32),
            "b": ((3,), [R, S0], torch.float32),
            "c": ((4, 6), [R, R], torch.float32),
            "d": ((7,), [R, R], torch.float32),
            "e": ((8, 4), [S0, S1], torch.bfloat16),
            "f": ((3, 5), [S0, S0], torch.float32)}
    rng = np.random.default_rng(5)

    def draw(scale, f=lambda a: a, dtype=None):
        return {k: torch.from_numpy(np.asarray(
            f(rng.normal(size=sh)) * scale, np.float32)).to(dtype or dt)
            for k, (sh, _, dt) in spec.items()}

    def place(tree):
        # copies: a replicated placement shares its input's storage
        return {k: distribute_tensor(t.clone(), mesh, spec[k][1])
                for k, t in tree.items()}

    def placed_state(st):
        return {"m": place(st["m"]), "v": place(st["v"]),
                "step": distribute_tensor(st["step"].clone(), mesh,
                                          [R, R])}

    def clone(tree):
        return pytree.tree_map(torch.clone, tree)

    cfg = TO.AdamWConfig(lr=1e-2)
    params = draw(1.0)
    state = {"m": draw(0.1, dtype=torch.float32),
             "v": draw(0.01, np.abs, dtype=torch.float32),
             "step": torch.tensor(3, dtype=torch.int32)}
    loss = torch.tensor(1.5)
    coord = mesh.get_coordinate()
    for name, scale in (("unclipped", 1e-2), ("clipped", 1.0)):
        grads = draw(scale)
        p1, s1 = clone(params), clone(state)
        want = TO.adamw_update_(grads, s1, p1, cfg, loss=loss)
        pd, sd = place(params), placed_state(state)
        gd = place(grads)
        got = TO.adamw_update_(gd, sd, pd, cfg, loss=loss)
        pf, sf = place(params), placed_state(state)
        np_, ns, got_f = TO.adamw_update(gd, sf, pf, cfg, loss=loss)
        mine = [full(pd[k]) for k in spec] + [full(sd[x][k]) for x in "mv"
                                             for k in spec]
        one = [p1[k] for k in spec] + [s1[x][k] for x in "mv" for k in spec]
        funct = [np_[k] for k in spec] + [ns[x][k] for x in "mv"
                                         for k in spec]
        # the shards a rank holds, keyed by its coordinates on the mesh
        # dimensions that shard the tensor: equal keys, equal bits
        local = {k: (tuple(c for c, pl in zip(coord, spec[k][1])
                           if pl.is_shard()), pd[k].to_local())
                 for k in spec}
        every = [None] * world
        dist.all_gather_object(every, local)
        copies_equal = all(
            bits_equal(a[k][1], b[k][1]) for a in every for b in every
            for k in spec if a[k][0] == b[k][0])
        copies = sum(a[k][0] == b[k][0] for a in every for b in every
                     for k in spec if a is not b)
        out[f"shards|{world}|{name}"] = {
            "norm": float(got), "one_device_norm": float(want),
            "clipped": float(want) > cfg.grad_clip,
            "bitwise": all(bits_equal(a, b) for a, b in zip(mine, one)),
            "rel_l2": sets_rel_l2(mine, one),
            "step": int(full(sd["step"])), "one_device_step": int(s1["step"]),
            "functional_bitwise": all(bits_equal(full(a), b) for a, b in
                                      zip(funct, mine))
            and torch.equal(got_f, got) and int(full(ns["step"])) == 4,
            "functional_placed": all(
                isinstance(np_[k], DTensor) and np_[k].placements ==
                pd[k].placements for k in spec),
            "functional_inputs_kept": all(bits_equal(full(pf[k]), params[k])
                                          for k in spec),
            "replicated_copies_equal": copies_equal,
            "replicated_copies": copies,
            "empty_shards": sum(a[k][1].numel() == 0 for a in every
                                for k in spec)}
    # a NaN partial loss on the last rank, or a NaN in its shard of "e":
    # no rank steps
    grads = draw(1e-2)
    for bad in ("loss", "grad"):
        pd, sd, gd = place(params), placed_state(state), place(grads)
        bad_loss = loss
        if bad == "loss":
            bad_loss = DTensor.from_local(torch.tensor(
                float("nan") if rank == world - 1 else 0.5), mesh,
                [Partial(), Partial()])
        elif rank == world - 1:
            gd["e"].to_local()[0, 0] = float("nan")
        TO.adamw_update_(gd, sd, pd, cfg, loss=bad_loss)
        out[f"skip|{world}|{bad}|rank{rank}"] = {
            "kept": all(bits_equal(pd[k].to_local(), place(params)[k]
                                   .to_local()) for k in spec),
            "step": int(sd["step"].to_local())}
    pd, sd, gd = place(params), placed_state(state), place(grads)
    gd["c"] = DTensor.from_local(gd["c"].to_local(), mesh,
                                 [Partial(), Replicate()], run_check=False)
    try:
        TO.adamw_update_(gd, sd, pd, cfg, loss=loss)
        raised = False
    except ValueError:
        raised = True
    out[f"partial_raises|{world}"] = raised


def ckpt_inplace_case(shape):
    # a checkpoint saved before an in-place step keeps what it saved; a
    # TrainProgram takes the mesh; train_loop steps through in_place
    import repro_torch.train.loop as TL
    from repro_torch.data.pipeline import SyntheticLM
    cfg = get_reduced_config("yi-6b")
    tcfg = TrainConfig()
    src = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, n_shards=4)
    batches = [src.batch_from_shard(src.load_shard(i)) for i in range(2)]
    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    o = adamw_init(p, tcfg.optimizer)
    mesh = make_mesh(shape, AXES2, "cpu")
    step = make_train_step(cfg, tcfg, mesh)
    pd, od = placed(cfg, p, o, mesh)
    batch = TL.batch_to_device(batches[0], "cpu")
    step.in_place(pd, od, batch)
    saved = [full(t).clone() for t in pytree.tree_leaves((pd, od))]
    mgr = CheckpointManager(f"{tmp}/ckpt_inplace_{world}")
    mgr.save((pd, od), 1)              # written in the background
    step.in_place(pd, od, batch)
    mgr.wait()
    moved = sum(not bits_equal(full(t), b) for t, b in zip(
        pytree.tree_leaves((pd, od)), saved))
    zeros = pytree.tree_map(
        lambda t: t * 0 if t.is_floating_point() else t, (pd, od))
    got = mgr.restore(zeros, 1)
    restored = all(bits_equal(full(a), b) for a, b in zip(
        pytree.tree_leaves(got), saved))
    program = TL.TrainProgram(step, pd, od, batch)
    res = {"moved": moved, "restored_bitwise": restored,
           "program_on_mesh": all(isinstance(v, DTensor)
                                  for v in program.batch.values())}
    if world == 2:
        # train_loop on the mesh never calls the functional update, and
        # equals functional steps bit for bit
        def functional_only(*a, **kw):
            raise AssertionError("the functional update was called")
        hist = []
        orig, TL.adamw_update = TL.adamw_update, functional_only
        try:
            lp, lo, _ = TL.train_loop(cfg, dataclasses.replace(
                tcfg, log_every=1), iter(batches), 2,
                                      device="cpu", mesh=mesh,
                                      log_fn=lambda s, m: hist.append(m))
        finally:
            TL.adamw_update = orig
        pf, of = placed(cfg, p, o, mesh)
        losses = []
        for b in batches:
            pf, of, m = step(pf, of, TL.batch_to_device(b, "cpu"))
            losses.append(float(m["loss"]))
        res["train_loop_losses_equal"] = [m["loss"] for m in hist] == losses
        res["train_loop_bitwise"] = all(bits_equal(full(a), full(b)) for a, b
                                        in zip(pytree.tree_leaves((lp, lo)),
                                               pytree.tree_leaves((pf, of))))
    out[f"ckpt_inplace|{shape}"] = res


def storage_owned(t):
    # the local tensor's storage holds its own bytes and no more: no view
    # into a whole leaf is kept
    loc = t.to_local()
    return loc.untyped_storage().nbytes() == loc.numel() * loc.element_size()


def gathered(res):
    rows = [None] * world
    dist.all_gather_object(rows, res)
    return rows


def init_all_case():
    # init_params(mesh=) of every reduced config against the whole init
    # placed, bit for bit, placements too
    from repro_torch.configs import list_archs
    mesh = make_mesh((world, 1), AXES2, "cpu")
    for arch in list_archs():
        cfg = get_reduced_config(arch)
        got = init_params(torch.Generator().manual_seed(0), cfg, "cpu",
                          mesh=mesh)
        whole = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        want = distribute(whole, mesh, param_shardings(whole, mesh, "train",
                                                       cfg))
        pairs = list(zip(pytree.tree_leaves(got), pytree.tree_leaves(want)))
        out[f"init_all|{world}|{arch}"] = gathered({
            "leaves": len(pairs), "all_dtensor": all(
                isinstance(a, DTensor) for a, _ in pairs),
            "bitwise": sum(a.placements == b.placements and bits_equal(
                a.to_local(), b.to_local()) for a, b in pairs),
            "owned": sum(storage_owned(a) for a, _ in pairs)})


def program_case(shape):
    # train_loop's initial state on the mesh is the whole init placed; the
    # sharded init holds no whole sharded leaf past its placement;
    # TrainProgram on the gloo mesh steps as step_fn.in_place does; a
    # resume is bitwise
    import weakref
    import repro_torch.models.transformer as TT
    import repro_torch.train.loop as TL
    from repro_torch.data.pipeline import SyntheticLM
    cfg = get_reduced_config("yi-6b")
    src = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, n_shards=4)
    batches = [src.batch_from_shard(src.load_shard(i)) for i in range(3)]
    mesh = make_mesh(shape, AXES2, "cpu")
    res = {}
    whole, max_alive = [], [0]
    inner = TT.place_local

    def watched(t, m, pls):
        max_alive[0] = max(max_alive[0], sum(r() is not None for r in whole))
        d = inner(t, m, pls)
        if d.to_local().untyped_storage().data_ptr() != \
                t.untyped_storage().data_ptr():
            whole.append(weakref.ref(t))     # a shard copied out of t
        return d
    TT.place_local = watched
    try:
        lp, lo, _ = TL.train_loop(cfg, TrainConfig(), iter(batches), 0,
                                  device="cpu", mesh=mesh)
    finally:
        TT.place_local = inner
    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    o = adamw_init(p, TrainConfig().optimizer)
    pw, ow = placed(cfg, p, o, mesh)
    pairs = list(zip(pytree.tree_leaves((lp, lo)), pytree.tree_leaves(
        (pw, ow))))
    res["init_bitwise"] = all(
        a.placements == b.placements and bits_equal(a.to_local(),
                                                    b.to_local())
        for a, b in pairs)
    res["leaves"] = len(pairs)
    res["owned"] = sum(storage_owned(a) for a, _ in pairs)
    res["sharded"] = sum(any(pl.is_shard() for pl in a.placements)
                         and a.to_local().numel() < a.numel()
                         for a, _ in pairs)
    res["copied_out"] = len(whole)
    res["max_whole_alive"] = max_alive[0]
    res["whole_alive_after"] = sum(r() is not None for r in whole)
    for micro in (1, 2):
        tcfg = TrainConfig(microbatches=micro)
        step = make_train_step(cfg, tcfg, mesh)
        pa, oa = placed(cfg, p, o, mesh)
        pb, ob = placed(cfg, p, o, mesh)
        program = TL.TrainProgram(step, pa, oa, TL.batch_to_device(
            batches[0], "cpu"))
        same = []
        for b in batches:
            b = TL.batch_to_device(b, "cpu")
            got = program.step(b)
            want = step.in_place(pb, ob, b)
            same += [bits_equal(got[k], want[k])
                     for k in ("loss", "grad_norm")]
        res[f"program_metrics_bitwise|{micro}"] = all(same)
        res[f"program_state_bitwise|{micro}"] = all(
            bits_equal(a.to_local(), b.to_local()) for a, b in zip(
                pytree.tree_leaves((pa, oa)), pytree.tree_leaves((pb, ob))))
        res[f"program_buffers_dtensor|{micro}"] = all(
            isinstance(v, DTensor) for v in program.batch.values())
    ckpt = f"{tmp}/ckpt_program_{world}"
    tcfg = TrainConfig(checkpoint_every=2)
    TL.train_loop(cfg, tcfg, iter(batches), 2, checkpoint_dir=ckpt,
                  device="cpu", mesh=mesh)
    rp, ro, _ = TL.train_loop(cfg, tcfg, iter(batches), 4,
                              checkpoint_dir=ckpt, device="cpu", mesh=mesh)
    step = make_train_step(cfg, tcfg, mesh)
    pb, ob = placed(cfg, p, o, mesh)
    for b in batches[:2] * 2:        # the resumed run restarts its batches
        step.in_place(pb, ob, TL.batch_to_device(b, "cpu"))
    res["resume_step"] = int(full(ro["step"]))
    res["resume_bitwise"] = all(
        a.placements == b.placements and bits_equal(a.to_local(),
                                                    b.to_local())
        for a, b in zip(pytree.tree_leaves((rp, ro)),
                        pytree.tree_leaves((pb, ob))))
    out[f"program|{shape}"] = gathered(res)


def mamba_block_case(shape):
    # K6's and K7's plain versions per rank on a mesh through
    # ops.causal_conv and ops.gated_norm (the norm's row split over model,
    # its sums all-reduced), forward and gradients, against the
    # single-device plain versions; the split plain backward on this
    # rank's share of the rows against the single-device one
    from torch.distributed.tensor import Shard
    from repro_torch.kernels import gated_norm as K7
    from repro_torch.kernels import mamba_conv as K6
    from repro_torch.kernels import ops
    mesh = make_mesh(shape, AXES2, "cpu")
    gen = torch.Generator().manual_seed(3)
    b, s, di, h, n = 2, 12, 128, 8, 16

    def rnd(*sh, scale=1.0, shift=0.0):
        return torch.randn(*sh, generator=gen) * scale + shift
    act, vec, mat = (Shard(0), Shard(2)), (Replicate(), Shard(0)), \
        (Replicate(), Shard(1))

    def leaf(t, pl):
        return distribute_tensor(t.clone(), mesh, pl).requires_grad_()
    res = {}
    y, xs, z, dout = (rnd(b, s, di) for _ in range(4))
    D, sc = rnd(h, scale=0.1, shift=1.0), rnd(di, scale=0.1, shift=1.0)
    dl = [leaf(t, act) for t in (y, xs, z)] + [leaf(t, vec) for t in (D, sc)]
    out_d = ops.gated_norm(*dl)
    out_d.backward(distribute_tensor(dout, mesh, act))
    sl = [t.clone().requires_grad_() for t in (y, xs, z, D, sc)]
    ref = K7.gated_norm_plain(*sl)
    ref.backward(dout)
    res["norm_out_rel_l2"] = rel_l2(full(out_d).detach(), ref.detach())
    res["norm_grad_rel_l2"] = max(rel_l2(full(a.grad), c.grad)
                                  for a, c in zip(dl, sl))
    tp, mr = shape[1], mesh.get_local_rank("model")
    loc = [t.chunk(tp, -1)[mr] for t in (dout, y, xs, z, D, sc)]
    got = K7.gated_norm_backward_plain(*loc, group=mesh.get_group("model"),
                                       width=di)
    want = K7.gated_norm_backward_plain(dout, y, xs, z, D, sc)
    res["norm_split_backward_rel_l2"] = max(
        rel_l2(g_, w_.chunk(tp, -1)[mr]) for g_, w_ in zip(got, want))
    widths = (di, n, n)
    xs3 = [rnd(b, s, c) for c in widths]
    ws = [rnd(4, c, scale=0.3) for c in widths]
    bs = [rnd(c, scale=0.1) for c in widths]
    gs = [rnd(b, s, c) for c in widths]
    sts = [rnd(b, 3, c) for c in widths]
    dx, dw, db = ([leaf(t, act) for t in xs3], [leaf(t, mat) for t in ws],
                  [leaf(t, vec) for t in bs])
    ys, new = ops.causal_conv(dx, dw, db)
    torch.autograd.backward(ys, [distribute_tensor(g_, mesh, act)
                                 for g_ in gs])
    sx, sw, sb = ([t.clone().requires_grad_() for t in ls]
                  for ls in (xs3, ws, bs))
    refs = [K6.causal_conv_plain(*a)[0] for a in zip(sx, sw, sb)]
    torch.autograd.backward(refs, gs)
    res["conv_out_rel_l2"] = max(rel_l2(full(a).detach(), c.detach())
                                 for a, c in zip(ys, refs))
    res["conv_grad_rel_l2"] = max(rel_l2(full(a.grad), c.grad) for a, c in
                                  zip(dx + dw + db, sx + sw + sb))
    res["conv_no_state"] = new is None
    with torch.no_grad():
        ys, new = ops.causal_conv(
            [distribute_tensor(t, mesh, act) for t in xs3],
            [distribute_tensor(t, mesh, mat) for t in ws],
            [distribute_tensor(t, mesh, vec) for t in bs],
            [distribute_tensor(t, mesh, act) for t in sts])
        refs = [K6.causal_conv_plain(*a) for a in zip(xs3, ws, bs, sts)]
    res["conv_state_rel_l2"] = max(
        max(rel_l2(full(a), r[0]), rel_l2(full(st), r[1]))
        for a, st, r in zip(ys, new, refs))
    out[f"mamba_block|{shape}"] = res


cases = sys.argv[1:]
for case in cases:
    kind, *arg = case.split(":")
    if kind == "train":
        train_case(arg[0], tuple(int(x) for x in arg[1].split(",")))
    elif kind == "grad":
        grad_case(arg[0], tuple(int(x) for x in arg[1].split(",")))
    elif kind == "moe":
        moe_case()
    elif kind == "moe_fallback":
        moe_fallback_case()
    elif kind == "compress":
        compression_case()
    elif kind == "save":
        checkpoint_save()
    elif kind == "restore":
        checkpoint_restore(tuple(int(x) for x in arg[0].split(",")))
    elif kind == "prefill":
        prefill_case(arg[0])
    elif kind == "inplace":
        inplace_case(arg[0], tuple(int(x) for x in arg[1].split(",")),
                     int(arg[2]))
    elif kind == "shards":
        shards_case()
    elif kind == "ckpt_inplace":
        ckpt_inplace_case(tuple(int(x) for x in arg[0].split(",")))
    elif kind == "program":
        program_case(tuple(int(x) for x in arg[0].split(",")))
    elif kind == "init_all":
        init_all_case()
    elif kind == "mamba_block":
        mamba_block_case(tuple(int(x) for x in arg[0].split(",")))
    elif kind == "remesh":
        from repro_torch.distributed.elastic import remesh
        m = remesh(model_parallel=2, device_type="cpu")
        out[f"remesh|world{world}"] = {"shape": list(m.shape),
                                       "axes": list(m.mesh_dim_names)}
    dist.barrier()
all_out = [None] * world
dist.all_gather_object(all_out, out)
if rank == 0:
    merged = {}
    for o in all_out:
        merged.update(o)
    with open(f"{tmp}/result_{group}.json", "w") as f:
        json.dump(merged, f)
dist.destroy_process_group()
"""


def _start(tmp: pathlib.Path, group: str, world: int, cases: list[str]):
    """One gloo group of ``world`` processes on its own ``FileStore``."""
    env = dict(os.environ, PYTHONPATH=str(SRC), TMPDIR_CASES=str(tmp),
               GROUP=group, WORLD=str(world), OMP_NUM_THREADS="1")
    return group, [subprocess.Popen([sys.executable, "-c", _WORKER, *cases],
                                    env=dict(env, RANK=str(r)),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
                   for r in range(world)]


def _finish(tmp: pathlib.Path, started, timeout: int = 600) -> dict:
    group, procs = started
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not errs, errs[0]
    with open(tmp / f"result_{group}.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The groups at world sizes 2 and 4 run at once; the restores at 4
    and 1 follow the save at 2."""
    tmp = tmp_path_factory.mktemp("gloo")
    two = _start(tmp, "two", 2,
                 [f"train:{a}:{m}" for m in ("2,1", "1,2")
                  for a in TRAIN_ARCHS]
                 + ["grad:deepseek-v3-671b:1,2", "grad:mamba2-1.3b:2,1",
                    "prefill:yi-6b", "prefill:mamba2-1.3b", "save",
                    "remesh", "inplace:yi-6b:2,1:1", "inplace:yi-6b:1,2:1",
                    "inplace:yi-6b:2,1:2", "shards", "ckpt_inplace:2,1",
                    "program:2,1", "init_all", "mamba_block:1,2"])
    four = _start(tmp, "four", 4,
                  [f"train:{a}:2,2" for a in TRAIN_ARCHS]
                  + ["grad:yi-6b:2,2", "moe", "moe_fallback", "compress",
                     "inplace:mamba2-1.3b:2,2:1", "shards",
                     "ckpt_inplace:2,2", "mamba_block:2,2"])
    one = _start(tmp, "one", 1, ["program:1,1", "init_all"])
    out = {}
    for started in (two, four, one):
        out.update(_finish(tmp, started))
    for started in (_start(tmp, "restore4", 4, ["restore:2,2"]),
                    _start(tmp, "restore1", 1, ["restore:1,1"])):
        out.update(_finish(tmp, started))
    return out


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_mamba_block_kernels_split_over_model(runs, mesh):
    """The Mamba block's conv (K6) and gated norm (K7) per rank with
    ``model`` = 2: outputs and gradients against the single-device plain
    versions (float32: the same ops per element; the norm's row sums in
    two parts, all-reduced), the split plain backward on a rank's share of
    the rows, and the conv from a state."""
    r = runs[f"mamba_block|{mesh}"]
    assert r["norm_out_rel_l2"] <= 1e-6, r
    assert r["norm_grad_rel_l2"] <= 1e-5, r
    assert r["norm_split_backward_rel_l2"] <= 1e-6, r
    assert r["conv_out_rel_l2"] <= 1e-6 and r["conv_state_rel_l2"] <= 1e-6
    assert r["conv_grad_rel_l2"] <= 1e-5 and r["conv_no_state"], r


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_matches_single_device(runs, arch, mesh):
    r = runs[f"train|{arch}|{mesh}"]
    assert r["all_dtensor"] and r["step"] == 1
    assert r["loss"] == pytest.approx(r["ref_loss"], rel=1e-5)
    assert r["grad_norm"] == pytest.approx(r["ref_grad_norm"], rel=1e-4)
    assert r["m_rel_l2"] < 1e-4 and r["v_rel_l2"] < 1e-4, r
    assert r["applied_rel_l2"] == 0.0, r
    assert r["update_rel_l2"] < 1e-2, r


@pytest.mark.parametrize("arch,mesh", [("deepseek-v3-671b", (1, 2)),
                                       ("mamba2-1.3b", (2, 1)),
                                       ("yi-6b", (2, 2))])
def test_sharded_gradients_match_in_float32(runs, arch, mesh):
    assert runs[f"grad|{arch}|{mesh}"]["worst_rel_l2"] < 1e-4


@pytest.mark.parametrize("mode", ["train", "serve"])
def test_moe_apply_ep_matches_moe_apply(runs, mode):
    r = runs[f"moe|{mode}"]
    assert r["ok"], r
    assert abs(r["aux"] - r["aux_ref"]) < 0.15 * r["aux_ref"] + 1e-3


@pytest.mark.parametrize("mode", ["train", "serve"])
def test_moe_fallback_keeps_experts_split(runs, mode):
    r = runs[f"moe_fallback|{mode}"]
    assert r["ok"], r
    assert r["aux"] == pytest.approx(r["aux_ref"], rel=1e-5)
    assert r["grad_rel_l2"] < 1e-4, r
    # train: each layer's data shards of one model rank's half of the
    # experts; serve: the experts stay split over the whole mesh.  Never
    # the whole layer
    assert r["gathered"] == (r["expert_bytes"] // 2 if mode == "train"
                             else 0), r


def test_compressed_all_reduce_over_two_pods(runs):
    rows = [v for k, v in runs.items() if k.startswith("compress|")]
    assert len(rows) == 4
    assert max(r["max_abs"] for r in rows) < 8e-2, rows
    assert all(r["counted"] for r in rows)


def test_crosspod_grad_sync_averages_over_pods(runs):
    """``make_crosspod_grad_sync`` on the 2-pod mesh: each leaf the mean
    over pods, within half of the compressed sum's tolerance compressed
    and at float32 rounding plain; the identity without a pod axis."""
    from repro_torch.distributed.compression import make_crosspod_grad_sync
    from repro_torch.launch.shardings import AbstractMesh
    rows = [v for k, v in runs.items() if k.startswith("compress|")]
    assert max(r["sync_compressed"] for r in rows) < 4e-2, rows
    assert max(r["sync_plain"] for r in rows) < 1e-6, rows
    tree = {"g": torch.ones(3)}
    assert make_crosspod_grad_sync(
        AbstractMesh((2, 2), ("data", "model")))(tree) is tree


def test_remesh_over_the_world(runs):
    assert runs["remesh|world2"] == {"shape": [1, 2],
                                     "axes": ["data", "model"]}


@pytest.mark.parametrize("mesh", [(2, 2), (1, 1)])
def test_checkpoint_restores_across_world_sizes(runs, mesh):
    assert runs[f"restore|{mesh}"]["bitwise"]


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-1.3b"])
def test_sharded_prefill_matches_unsharded(runs, arch):
    r = runs[f"prefill|{arch}"]
    assert r["ok"] and r["caches_ok"], r
    assert r["per_rank_calls"] > 0


INPLACE_CASES = [("yi-6b", (2, 1), 1), ("yi-6b", (1, 2), 1),
                 ("yi-6b", (2, 1), 2), ("mamba2-1.3b", (2, 2), 1)]


@pytest.mark.parametrize("clip", ["unclipped", "clipped"])
@pytest.mark.parametrize("arch,mesh,micro", INPLACE_CASES)
def test_in_place_sharded_step_matches_plain_dtensor_step(runs, arch, mesh,
                                                          micro, clip):
    """The in-place mesh step (K5's path on local shards) against the
    functional step of K5's plain version on the DTensors: bit for bit
    under the clip, relative L2 1e-6 clipped; the norm within 1e-6 of the
    same gradients' norm on one device; storage kept; with microbatches
    the functional mesh step gives the same bits."""
    r = runs[f"inplace|{arch}|{mesh}|{micro}|{clip}"]
    assert r["clipped"] == (clip == "clipped"), r
    assert r["all_dtensor"] and r["pointers_kept"], r
    assert r["step"] == r["want_step"] == 8, r
    assert r["norm"] == pytest.approx(r["one_device_norm"], rel=1e-6)
    if clip == "unclipped":
        assert r["bitwise"], r
    else:
        assert max(r["rel_l2"].values()) <= 1e-6, r
    if micro > 1:
        assert r["functional_bitwise"], r


@pytest.mark.parametrize("clip", ["unclipped", "clipped"])
@pytest.mark.parametrize("world", [2, 4])
def test_local_shard_update_matches_one_device(runs, world, clip):
    """Sharded, replicated, uneven and empty shards: the norm within 1e-6
    of the whole tensors' (a replicated tensor counted once), bit for bit
    unclipped, relative L2 1e-6 clipped; the functional form equal bit for
    bit, placed as its inputs, the inputs kept."""
    r = runs[f"shards|{world}|{clip}"]
    assert r["clipped"] == (clip == "clipped"), r
    assert r["norm"] == pytest.approx(r["one_device_norm"], rel=1e-6)
    assert r["step"] == r["one_device_step"] == 4
    if clip == "unclipped":
        assert r["bitwise"], r
    else:
        assert r["rel_l2"] <= 1e-6, r
    assert r["functional_bitwise"] and r["functional_placed"], r
    assert r["functional_inputs_kept"], r
    assert r["empty_shards"] == (1 if world == 4 else 0), r


@pytest.mark.parametrize("world", [2, 4])
def test_replicated_shards_stay_equal_across_ranks(runs, world):
    for clip in ("unclipped", "clipped"):
        r = runs[f"shards|{world}|{clip}"]
        assert r["replicated_copies"] > 0 and r["replicated_copies_equal"]


@pytest.mark.parametrize("bad", ["loss", "grad"])
@pytest.mark.parametrize("world", [2, 4])
def test_non_finite_on_one_rank_skips_every_rank(runs, world, bad):
    """A NaN partial loss on the last rank only (the whole loss is NaN),
    or a NaN in its shard of one gradient: every rank keeps its shards
    and its step."""
    rows = [runs[f"skip|{world}|{bad}|rank{r}"] for r in range(world)]
    assert all(r["kept"] and r["step"] == 3 for r in rows), rows


@pytest.mark.parametrize("world", [2, 4])
def test_partial_gradient_is_refused(runs, world):
    assert runs[f"partial_raises|{world}"]


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_checkpoint_before_an_in_place_step_keeps_its_values(runs, mesh):
    r = runs[f"ckpt_inplace|{mesh}"]
    assert r["moved"] > 0 and r["restored_bitwise"], r
    assert r["program_on_mesh"], r


def test_train_loop_on_a_mesh_steps_in_place(runs):
    r = runs["ckpt_inplace|(2, 1)"]
    assert r["train_loop_losses_equal"] and r["train_loop_bitwise"], r


@pytest.mark.parametrize("world", [1, 2])
def test_train_loop_initial_state_is_the_placed_init(runs, world):
    """``train_loop(..., mesh=)``'s parameters and moments before a step
    are bit for bit the whole seed-0 init and ``adamw_init`` placed by
    ``place_state``, placements too, and every local tensor owns its
    storage (its bytes are the shard's: no view into a whole leaf)."""
    mesh = (world, 1)
    for r in runs[f"program|{mesh}"]:
        assert r["init_bitwise"], r
        assert r["owned"] == r["leaves"], r
        assert (r["sharded"] > 0) == (world > 1), r


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_init_holds_one_whole_leaf_at_a_time(runs, world):
    """When the sharded init places a leaf, no earlier leaf whose shard was
    copied out of it is alive: a rank holds its shards and one whole
    leaf."""
    for r in runs[f"program|{(world, 1)}"]:
        assert r["max_whole_alive"] == 0 and r["whole_alive_after"] == 0, r
        assert r["copied_out"] > 0, r


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("world", [1, 2])
def test_train_program_on_a_mesh_equals_in_place_steps(runs, world, micro):
    """``TrainProgram`` on a gloo mesh (DTensor batch buffers loaded rank
    by rank, eager steps) against ``step_fn.in_place`` on the same placed
    state and batches: every loss and grad norm and the final shards bit
    for bit, with 1 and 2 microbatches."""
    for r in runs[f"program|{(world, 1)}"]:
        assert r[f"program_metrics_bitwise|{micro}"], r
        assert r[f"program_state_bitwise|{micro}"], r
        assert r[f"program_buffers_dtensor|{micro}"], r


@pytest.mark.parametrize("world", [1, 2])
def test_train_loop_on_a_mesh_resumes_bitwise(runs, world):
    """``train_loop(..., mesh=)`` to step 2 with a checkpoint, then resumed
    to step 4 (its batches restarted), against four in-place steps from
    the placed init: every shard bit for bit."""
    for r in runs[f"program|{(world, 1)}"]:
        assert r["resume_step"] == 4 and r["resume_bitwise"], r


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-27b", "starcoder2-7b",
                                  "stablelm-12b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b", "deepseek-v3-671b",
                                  "arctic-480b", "musicgen-large",
                                  "paligemma-3b"])
def test_sharded_init_of_every_config_is_the_placed_init(runs, arch, world):
    """``init_params(..., mesh=)`` of each reduced config: every leaf a
    DTensor, bit for bit the whole init placed by ``param_shardings``, and
    every local tensor owning its storage."""
    for r in runs[f"init_all|{world}|{arch}"]:
        assert r["all_dtensor"] and r["leaves"] > 0, r
        assert r["bitwise"] == r["owned"] == r["leaves"], r


def test_chip_smoke_phase_9d_runs_on_cpu_ranks():
    """``chip_smoke.py`` phase 9d's two ranks (spawned processes in one
    gloo group, K5 on the local shards of a split parameter set, held to
    one rank's update on the whole set) at reduced mamba2-1.3b on the
    CPU, where K5 is its plain version: the phase's own gates pass, and
    every element is counted in the norm once."""
    sys.path.insert(0, str(SRC.parent))
    import chip_smoke
    from repro_torch.configs import get_reduced_config
    out = chip_smoke.phase_k5_mesh(torch, get_reduced_config("mamba2-1.3b"),
                                   "cpu")
    rows = out["ranks"]
    assert [r["rank"] for r in rows] == [0, 1]
    assert all(r["bitwise"] and r["norm_rel"] == 0.0 for r in rows), rows
    assert sum(r["counted_elements"] for r in rows) == rows[0]["elements"]
    assert 0 < rows[0]["replicated"] < rows[0]["tensors"]
