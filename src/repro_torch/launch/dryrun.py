"""Multi-pod dry run: every (architecture × input shape × mesh) cell on a
fake process group of 256 or 512 ranks, on the meta device.

For each cell the real entry — the train step (train shapes), ``prefill``
(prefill shapes) or ``decode_step`` (decode shapes) — runs on meta
DTensors placed by the production shardings (``train`` or ``serve``
mode; bf16 AdamW moments for d_model >= 7168), under the decode cache
hints and the MoE ``moe_ep`` hint, and under the collective counter.  The
process is rank 0 of the fake group: it sees rank 0's shards and issues
rank 0's collectives, which complete without moving data.  Per cell it
records:

- per-device bytes of parameters, optimizer state, caches and inputs,
  from the local shapes, and whether they fit one card's 80 GB;
- FLOPs from the analytical model (``roofline.flops_model``);
- collective bytes by kind, counted as the run issues them;
- ``roofline_terms`` with the H100 constants.

What the JAX package's dry run does that this one does not: it compiles
for 512 host devices (``XLA_FLAGS``), reads XLA's memory analysis, and
extrapolates bytes and collectives from 1- and 2-unit probe compiles.
Nothing here compiles; the run executes every unit, so its collective
count is exact for rank 0 and needs no probes.  ``--no-run`` records only
the placement and byte part of a cell (and the analytical terms without
collectives); a cell whose entry is not run says so in ``run``.

A process group is set once per process, so ``--all`` runs one
subprocess per mesh.  Results accumulate in ``--out`` (default
``$DRYRUN_RESULTS`` or ``dryrun_torch_results.json``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-done]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --reduced --mesh-shape 2,2,2
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs import (SHAPES, cells, get_config,
                                 get_reduced_config)
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.ctx import sharding_hints
from repro_torch.launch.shardings import (_axis_size, _dp_axes, _dp_size,
                                          batch_sharding, param_shardings)
from repro_torch.launch.specs import (cache_shardings, cache_specs,
                                      decode_input_specs,
                                      prefill_input_specs, token_sharding,
                                      train_input_specs)
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            param_shapes, prefill)
from repro_torch.roofline.analysis import collective_bytes, roofline_terms
from repro_torch.roofline.flops_model import (cell_flops, cell_hbm_bytes,
                                              kv_cache_bytes, param_bytes)
from repro_torch.train.loop import TrainConfig, make_train_step
from repro_torch.train.optimizer import AdamWConfig, adamw_init

DEFAULT_OUT = "dryrun_torch_results.json"
CARD_BYTES = 80e9             # one H100's HBM

MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}

# the reduced configs' shape grid: the production kinds at a CPU-test size
SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 64, 8, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 64, 8, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 64, 8, "decode"),
    "long_500k": ShapeSpec("long_500k", 128, 1, "decode"),
}


def _opt_cfg(cfg: ModelConfig) -> AdamWConfig:
    big = cfg.d_model >= 7168
    return AdamWConfig(moment_dtype=torch.bfloat16 if big else torch.float32)


def _place(tree, mesh, placements):
    """Meta stand-ins -> meta DTensors: each rank's chunk, no data moved."""
    leaves, spec = pytree.tree_flatten(tree)
    pls = pytree.tree_leaves(placements,
                             is_leaf=lambda x: isinstance(x, tuple))
    return pytree.tree_unflatten(
        [distribute_tensor(t, mesh, list(p), src_data_rank=None)
         for t, p in zip(leaves, pls)], spec)


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               if isinstance(t, DTensor) else t.numel() * t.element_size()
               for t in pytree.tree_leaves(tree))


def _decode_hints(cfg: ModelConfig, shape, mesh) -> dict:
    """Hints pinning the per-step cache updates to the cache layout."""
    dp = _dp_axes(mesh)
    dpn = _dp_size(mesh)
    b = shape.global_batch
    big = b % max(dpn, 1) == 0 and b >= dpn
    tp = _axis_size(mesh, "model")

    def kv_hint(x):
        hax = "model" if x.shape[2] % tp == 0 else None
        return (dp, None, hax, None) if big else (None, "data", hax, None)

    def lat_hint(x):
        return (dp, None, None) if big else (None, "data", None)

    return {"kv_cache": kv_hint, "latent_cache": lat_hint}


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Meta DTensor arguments of the cell's entry, the entry itself, and
    the per-device bytes by part."""
    mode = "train" if shape.kind == "train" else "serve"
    pshapes = param_shapes(cfg)
    params = _place(pshapes, mesh, param_shardings(pshapes, mesh, mode, cfg))
    parts = {"params": _local_bytes(params)}
    if shape.kind == "train":
        tcfg = TrainConfig(optimizer=_opt_cfg(cfg))
        opt = adamw_init(params, tcfg.optimizer)
        batch = {k: _place(v, mesh, batch_sharding(mesh, v.dim()))
                 for k, v in train_input_specs(cfg, shape).items()}
        parts["optimizer"] = _local_bytes(opt)
        parts["inputs"] = _local_bytes(batch)
        step = make_train_step(cfg, tcfg, mesh)
        return (lambda: step(params, opt, batch)), parts
    if shape.kind == "prefill":
        inputs = {k: _place(v, mesh, batch_sharding(mesh, v.dim()))
                  for k, v in prefill_input_specs(cfg, shape).items()}
        max_len = shape.seq_len + cfg.n_prefix + 1
        parts["inputs"] = _local_bytes(inputs)
        parts["caches"] = _local_bytes(_place(
            cache_specs(cfg, shape.global_batch, max_len), mesh,
            cache_shardings(cfg, shape.global_batch, max_len, mesh)))

        def run():
            with torch.no_grad():
                return prefill(params, cfg, inputs["tokens"],
                               inputs.get("prefix_embeddings"),
                               max_len=max_len)
        return run, parts
    dspecs = decode_input_specs(cfg, shape)
    token = _place(dspecs["token"], mesh,
                   token_sharding(cfg, shape.global_batch, mesh))
    caches = _place(dspecs["caches"], mesh,
                    cache_shardings(cfg, shape.global_batch, shape.seq_len,
                                    mesh))
    parts["inputs"] = _local_bytes(token)
    parts["caches"] = _local_bytes(caches)

    def run():
        with torch.no_grad():
            return decode_step(params, cfg, token, caches, shape.seq_len - 1)
    return run, parts


def run_cell(arch: str, shape: ShapeSpec, mesh, mesh_name: str, *,
             reduced: bool = False, run: bool = True) -> dict:
    t0 = time.time()
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    n_dev = mesh.size()
    fn, parts = build_cell(cfg, shape, mesh)
    entry = {
        "arch": arch, "shape": shape.name, "reduced": reduced,
        "mesh": mesh_name, "mesh_shape": list(mesh.shape),
        "n_devices": n_dev, "ok": True,
        "bytes_per_device": parts,
        "total_bytes_per_device": sum(parts.values()),
    }
    entry["fits_80gb"] = entry["total_bytes_per_device"] <= CARD_BYTES
    flops = cell_flops(cfg, shape, n_dev, remat=(shape.kind == "train"))
    entry["flops"] = flops["per_device"]
    entry["flops_global"] = flops["global"]
    entry["param_bytes_per_dev"] = param_bytes(cfg) / n_dev
    entry["hbm_model_bytes"] = cell_hbm_bytes(cfg, shape, n_dev)["per_device"]
    entry["min_hbm_bytes"] = (
        param_bytes(cfg) + (kv_cache_bytes(cfg, shape.global_batch,
                                           shape.seq_len)
                            if shape.kind != "train" else 0.0)) / n_dev
    entry["run"] = run
    if run:
        hints = _decode_hints(cfg, shape, mesh) \
            if shape.kind == "decode" else {}
        if cfg.moe is not None:
            hints["moe_ep"] = mesh
            hints["moe_mode"] = "train" if shape.kind == "train" else "serve"
        with sharding_hints(**hints), collective_bytes() as coll:
            fn()
        entry["collective_bytes"] = coll.bytes
        entry["collective_calls"] = coll.calls
    entry["seconds"] = round(time.time() - t0, 1)
    entry.update(roofline_terms(entry, cfg, shape))
    return entry


def cell_key(arch: str, shape_name: str, mesh_name: str,
             reduced: bool) -> str:
    return f"{arch}|{shape_name}|{mesh_name}" + ("|reduced" if reduced
                                                 else "")


def init_fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """Rank 0 of a fake process group of ``prod(shape)`` ranks, and the
    mesh over it (``cpu`` mesh, meta tensors)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def load_results(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def _save(path: str, results: dict) -> None:
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


def run_mesh(mesh_name: str, todo: list[tuple[str, str]], out: str, *,
             mesh_shape=None, reduced=False, run=True,
             skip_done=False) -> int:
    """Every cell of ``todo`` on one mesh, in this process; returns the
    number of failed cells."""
    if mesh_shape is None:
        mesh_shape, axes = MESHES[mesh_name]
    else:
        axes = ("data", "model") if len(mesh_shape) == 2 else \
            ("pod", "data", "model")
    mesh = init_fake_mesh(tuple(mesh_shape), axes)
    grid = SMOKE_SHAPES if reduced else SHAPES
    failed = 0
    for arch, shape_name in todo:
        key = cell_key(arch, shape_name, mesh_name, reduced)
        results = load_results(out)
        if skip_done and results.get(key, {}).get("ok"):
            print(f"[skip] {key}", flush=True)
            continue
        try:
            entry = run_cell(arch, grid[shape_name], mesh, mesh_name,
                             reduced=reduced, run=run)
            coll = sum(entry.get("collective_bytes", {}).values())
            print(f"[OK] {key}: GiB/dev="
                  f"{entry['total_bytes_per_device'] / 2**30:.3f} "
                  f"flops/dev={entry['flops']:.3e} coll={coll:.3e}B "
                  f"dom={entry['dominant']} ({entry['seconds']}s)",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — a failing cell is recorded
            failed += 1
            entry = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                     "reduced": reduced, "ok": False,
                     "error": f"{type(e).__name__}: {e}"}
            print(f"[FAIL] {key}: {entry['error']}", flush=True)
            traceback.print_exc()
        results = load_results(out)
        results[key] = entry
        _save(out, results)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=sorted(MESHES),
                    help="with --all: this mesh only, in this process")
    ap.add_argument("--mesh-shape",
                    help="a test mesh instead of the production one, e.g. "
                         "2,2,2 (pod, data, model) or 2,2 (data, model)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs on the smoke shape grid")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--no-run", action="store_true",
                    help="placements and bytes only; no entry is run")
    ap.add_argument("--out", default=os.environ.get("DRYRUN_RESULTS",
                                                    DEFAULT_OUT))
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    kw = dict(mesh_shape=mesh_shape, reduced=args.reduced,
              run=not args.no_run, skip_done=args.skip_done)
    if args.all:
        todo = cells()
        if mesh_shape is not None:
            name = "x".join(map(str, mesh_shape))
            return 1 if run_mesh(name, todo, args.out, **kw) else 0
        if args.mesh:
            return 1 if run_mesh(args.mesh, todo, args.out, **kw) else 0
        rcs = []
        for name in MESHES:      # one process group per process
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--all", "--mesh", name, "--out", args.out]
            cmd += [f for f, on in (("--reduced", args.reduced),
                                    ("--skip-done", args.skip_done),
                                    ("--no-run", args.no_run)) if on]
            rcs.append(subprocess.run(cmd).returncode)
        results = load_results(args.out)
        n_ok = sum(1 for v in results.values() if v.get("ok"))
        print(f"== {n_ok}/{len(results)} cells OK ==")
        return 0 if not any(rcs) else 1
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    name = ("x".join(map(str, mesh_shape)) if mesh_shape else
            ("multi" if args.multi_pod else "single"))
    return 1 if run_mesh(name, [(args.arch, args.shape)], args.out,
                         **kw) else 0


if __name__ == "__main__":
    sys.exit(main())
