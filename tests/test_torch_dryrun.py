"""The port's dry run (``repro_torch.launch.dryrun``) in subprocesses, each
rank 0 of a fake process group: all ten reduced configs, for each of the
train, prefill and decode kinds, on a fake 8-rank (2, 2, 2) mesh (the
smoke shape grid), and one full-size cell, yi-6b ``train_4k`` on the
(16, 16) production mesh.  Every cell must run its entry on meta DTensors,
give finite roofline terms, and hold per device exactly the bytes of
parameters, optimizer state, inputs and caches that ``repro``'s specs
imply on a ``jax.sharding.AbstractMesh`` of the same shape."""
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh

import repro.configs as J
import repro.launch.shardings as JS
import repro.launch.specs as JP
from repro.models.transformer import init_params as repro_init
from repro.train.optimizer import AdamWConfig, adamw_init
from repro_torch.launch.dryrun import SMOKE_SHAPES

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REDUCED_MESH = (2, 2, 2)
KINDS = {"train": ["train_4k"], "prefill": ["prefill_32k"],
         "decode": ["decode_32k", "long_500k"]}

_RUN = r"""
import json, sys
from repro_torch.launch.dryrun import run_mesh
mesh, reduced, out = json.loads(sys.argv[1]), sys.argv[2] == "1", sys.argv[3]
todo = [tuple(c) for c in json.loads(sys.argv[4])]
name = "x".join(map(str, mesh))
sys.exit(1 if run_mesh(name, todo, out, mesh_shape=tuple(mesh),
                       reduced=reduced) else 0)
"""


def _start(mesh, reduced: bool, out: pathlib.Path, todo):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-c", _RUN, json.dumps(list(mesh)),
         "1" if reduced else "0", str(out), json.dumps(todo)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _reduced_todo(kinds):
    return [(a, s) for a, s in J.cells()
            if any(s in KINDS[k] for k in kinds)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Six dry-run processes at once, of about equal work: the reduced
    train cells in thirds, the reduced prefill and decode cells in
    halves, and the full-size cell."""
    tmp = tmp_path_factory.mktemp("dryrun")
    train = _reduced_todo(["train"])
    serve = _reduced_todo(["prefill", "decode"])
    groups = [train[0::3], train[1::3], train[2::3], serve[0::2],
              serve[1::2]]
    procs = [(_start(REDUCED_MESH, True, tmp / f"r{i}.json", g),
              tmp / f"r{i}.json") for i, g in enumerate(groups)]
    procs.append((_start((16, 16), False, tmp / "full.json",
                         [("yi-6b", "train_4k")]), tmp / "full.json"))
    out = {}
    for p, path in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        with open(path) as f:
            out.update(json.load(f))
    return out


def _local_bytes(shapes, shardings, mesh) -> int:
    total = 0
    for leaf, sh in zip(jax.tree_util.tree_leaves(shapes),
                        jax.tree_util.tree_leaves(shardings)):
        dims = list(leaf.shape)
        for i, entry in enumerate(sh.spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            k = math.prod(mesh.shape[a] for a in axes)
            assert dims[i] % k == 0
            dims[i] //= k
        total += math.prod(dims) * jnp.dtype(leaf.dtype).itemsize
    return total


def repro_bytes(arch: str, shape, mesh_shape, reduced: bool) -> dict:
    """Per-device bytes by part that ``repro``'s specs imply."""
    axes = ("data", "model") if len(mesh_shape) == 2 else \
        ("pod", "data", "model")
    mesh = AbstractMesh(mesh_shape, axes)
    cfg = J.get_reduced_config(arch) if reduced else J.get_config(arch)
    pshapes = jax.eval_shape(lambda k: repro_init(k, cfg),
                             jax.random.PRNGKey(0))
    mode = "train" if shape.kind == "train" else "serve"
    parts = {"params": _local_bytes(
        pshapes, JS.param_shardings(pshapes, mesh, mode, cfg), mesh)}

    def batch(specs):
        return sum(_local_bytes(v, JS.batch_sharding(mesh, v.ndim), mesh)
                   for v in specs.values())

    if shape.kind == "train":
        ocfg = AdamWConfig(moment_dtype=jnp.bfloat16 if cfg.d_model >= 7168
                           else jnp.float32)
        oshapes = jax.eval_shape(lambda p: adamw_init(p, ocfg), pshapes)
        parts["optimizer"] = _local_bytes(
            oshapes, JS.param_shardings(oshapes, mesh, mode, cfg), mesh)
        parts["inputs"] = batch(JP.train_input_specs(cfg, shape))
    elif shape.kind == "prefill":
        max_len = shape.seq_len + cfg.n_prefix + 1
        parts["inputs"] = batch(JP.prefill_input_specs(cfg, shape))
        parts["caches"] = _local_bytes(
            JP.cache_specs(cfg, shape.global_batch, max_len),
            JP.cache_shardings(cfg, shape.global_batch, max_len, mesh),
            mesh)
    else:
        dspecs = JP.decode_input_specs(cfg, shape)
        parts["inputs"] = _local_bytes(
            dspecs["token"], JP.token_sharding(cfg, shape.global_batch,
                                               mesh), mesh)
        parts["caches"] = _local_bytes(
            dspecs["caches"], JP.cache_shardings(
                cfg, shape.global_batch, shape.seq_len, mesh), mesh)
    return parts


def _check(entry: dict, want: dict) -> None:
    assert entry["ok"] and entry["run"], entry
    for k in ("t_compute_s", "t_memory_s", "t_collective_s",
              "roofline_fraction", "flops"):
        assert math.isfinite(entry[k]) and entry[k] >= 0, (k, entry[k])
    assert entry["dominant"] in ("compute", "memory", "collective")
    assert set(entry["collective_bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert entry["bytes_per_device"] == want


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", J.list_archs())
def test_reduced_cells_on_fake_8_ranks(results, arch, kind):
    cells = [s for a, s in J.cells() if a == arch and s in KINDS[kind]]
    assert cells
    for shape_name in cells:
        entry = results[f"{arch}|{shape_name}|2x2x2|reduced"]
        want = repro_bytes(arch, SMOKE_SHAPES[shape_name], REDUCED_MESH,
                           reduced=True)
        _check(entry, want)
        # the sharded run issued collectives (8 ranks, sharded weights)
        if kind == "train":
            assert sum(entry["collective_bytes"].values()) > 0


def test_full_size_yi_train_cell(results):
    entry = results["yi-6b|train_4k|16x16"]
    _check(entry, repro_bytes("yi-6b", J.SHAPES["train_4k"], (16, 16),
                              reduced=False))
    assert entry["n_devices"] == 256 and entry["fits_80gb"]
    assert entry["flops"] == pytest.approx(2.0852e14, rel=0.05)
