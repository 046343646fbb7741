"""The port's sharding rules against ``repro``'s, leaf by leaf, on every
full-size config at both production meshes, with nothing allocated:
``repro``'s shapes from ``jax.eval_shape`` on a
``jax.sharding.AbstractMesh``, the port's from its meta path
(``param_shapes``, ``cache_specs``).

The port's ``params["units"]`` is a list over units of per-layer trees;
``repro`` stacks each pattern position's units on a leading axis.  So a
port unit leaf ``units/<u>/<j>/...`` carries the spec of ``repro``'s
``units/<j>/...`` with that leading axis's ``None`` dropped, for every u.
Specs are compared as one entry per tensor dimension (``repro``'s
``PartitionSpec`` padded with ``None``)."""
import functools
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch.utils._pytree as pytree
from jax.sharding import AbstractMesh

import repro.configs as J
import repro.launch.shardings as JS
import repro.launch.specs as JP
import repro_torch.configs as T
import repro_torch.launch.shardings as TS
import repro_torch.launch.specs as TP
from repro.models.transformer import init_params as repro_init
from repro_torch.models.transformer import param_shapes

ARCHS = J.list_archs()
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("train", "serve", "fsdp")
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _jax_mesh(name):
    return AbstractMesh(*MESHES[name])


def _port_mesh(name):
    shape, axes = MESHES[name]
    return TS.AbstractMesh(shape, axes)


@functools.lru_cache(maxsize=None)
def _repro_shapes(arch):
    return jax.eval_shape(lambda k: repro_init(k, J.get_config(arch)),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    return param_shapes(T.get_config(arch))


def _jkey(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


def _tkey(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def local_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    """The largest local shard of a ``shape`` tensor under ``spec``."""
    out = []
    for size, entry in zip(shape, spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        k = math.prod(mesh.shape[mesh.mesh_dim_names.index(a)]
                      for a in axes)
        out.append(-(-size // k))
    return tuple(out) + tuple(shape[len(out):])


def _padded(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _repro_specs(arch, mesh_name, mode):
    """name -> (spec per dimension, shape), the units' stack axis dropped."""
    shapes = _repro_shapes(arch)
    shardings = JS.param_shardings(shapes, _jax_mesh(mesh_name), mode,
                                   J.get_config(arch))
    out = {}
    for (path, leaf), sh in zip(
            jax.tree_util.tree_flatten_with_path(shapes)[0],
            jax.tree_util.tree_leaves(shardings)):
        names = [_jkey(k) for k in path]
        spec = _padded(sh.spec, leaf.ndim)
        shape = tuple(leaf.shape)
        if names[0] == "units":
            assert spec[0] is None, (names, spec)
            spec, shape = spec[1:], shape[1:]
        out["/".join(names)] = (spec, shape)
    return out


def _port_name(names: list[str]) -> str:
    """``units/<u>/<j>/...`` -> ``units/<j>/...`` (repro's stacked name)."""
    if names[0] == "units":
        names = [names[0]] + names[2:]
    return "/".join(names)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_repro(arch, mesh_name, mode):
    want = _repro_specs(arch, mesh_name, mode)
    shapes = _port_shapes(arch)
    specs = TS.param_specs(shapes, _port_mesh(mesh_name), mode,
                           T.get_config(arch))
    flat, _ = pytree.tree_flatten_with_path(shapes)
    got_specs = pytree.tree_leaves(specs,
                                   is_leaf=lambda x: isinstance(x, tuple))
    seen = set()
    for (path, leaf), spec in zip(flat, got_specs):
        name = _port_name([_tkey(k) for k in path])
        want_spec, want_shape = want[name]
        assert tuple(leaf.shape) == want_shape, name
        assert spec == want_spec, (name, spec, want_spec)
        seen.add(name)
    assert seen == set(want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_match_repro(arch, mesh_name):
    """Every decode cell's caches, tokens and inputs: shapes, dtypes and
    specs (``cache_shardings``, ``token_sharding``, ``batch_spec``)."""
    jcfg, tcfg = J.get_config(arch), T.get_config(arch)
    jmesh, tmesh = _jax_mesh(mesh_name), _port_mesh(mesh_name)
    for shape_name in ("decode_32k", "long_500k"):
        if (arch, shape_name) not in J.cells():
            continue
        jshape, tshape = J.SHAPES[shape_name], T.SHAPES[shape_name]
        b, s = jshape.global_batch, jshape.seq_len
        jc = JP.cache_specs(jcfg, b, s)
        js = JP.cache_shardings(jcfg, b, s, jmesh)
        want = {}
        for (path, leaf), sh in zip(
                jax.tree_util.tree_flatten_with_path(jc)[0],
                jax.tree_util.tree_leaves(js)):
            names = [_jkey(k) for k in path]
            spec, shape = _padded(sh.spec, leaf.ndim), tuple(leaf.shape)
            if names[0] == "units":
                assert spec[0] is None
                spec, shape = spec[1:], shape[1:]
            want["/".join(names)] = (spec, shape, str(leaf.dtype))
        tc = TP.cache_specs(tcfg, b, s)
        tspecs = TP.cache_leaf_specs(tcfg, b, s, tmesh)
        flat, _ = pytree.tree_flatten_with_path(tc)
        for (path, leaf), spec in zip(flat, pytree.tree_leaves(
                tspecs, is_leaf=lambda x: isinstance(x, tuple))):
            name = _port_name([_tkey(k) for k in path])
            w_spec, w_shape, w_dtype = want[name]
            assert (_padded(spec, leaf.dim()), tuple(leaf.shape),
                    str(leaf.dtype).replace("torch.", "")) == \
                (w_spec, w_shape, w_dtype), name
        jt = JP.token_sharding(jcfg, b, jmesh).spec
        tok = TP.decode_input_specs(tcfg, tshape)["token"]
        assert TP.token_spec(tcfg, b, tmesh) == _padded(jt, tok.dim())
    for shape_name in ("train_4k", "prefill_32k"):
        jspecs = (JP.train_input_specs if shape_name == "train_4k"
                  else JP.prefill_input_specs)(jcfg, J.SHAPES[shape_name])
        tspecs = (TP.train_input_specs if shape_name == "train_4k"
                  else TP.prefill_input_specs)(tcfg, T.SHAPES[shape_name])
        assert list(jspecs) == list(tspecs)
        for k, v in tspecs.items():
            assert tuple(v.shape) == tuple(jspecs[k].shape), k
            assert _padded(TS.batch_spec(tmesh, v.dim()), v.dim()) == \
                _padded(JS.batch_spec(jmesh, v.dim()), v.dim())


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cache_spec_rule_matches_repro(mesh_name):
    jmesh, tmesh = _jax_mesh(mesh_name), _port_mesh(mesh_name)
    for batch in (1, 8, 32, 128):
        for leafname in ("k", "v", "c", "k_rope", "ssm", "x"):
            for ndim in (2, 3, 4):
                want = tuple(JS.cache_spec(jmesh, batch, leafname, ndim))
                assert TS.cache_spec(tmesh, batch, leafname, ndim) == want


def test_to_placements_splits_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _port_mesh("multi")
    assert TS.to_placements((("pod", "data"), "model"), mesh) == \
        (Shard(0), Shard(0), Shard(1))
    assert TS.to_placements((None, None), mesh) == (Replicate(),) * 3
    assert TS.to_placements((("model", "pod", "data"), None, None),
                            mesh) == (Shard(0),) * 3
    assert local_shape((256, 7168, 2048), (("model", "pod", "data"),
                                              None, None), mesh) == \
        (1, 7168, 2048)


_LOCAL_SHAPES = r"""
import math, sys
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.tensor import distribute_tensor
import repro_torch.configs as T
import repro_torch.launch.shardings as TS
from repro_torch.launch.dryrun import init_fake_mesh
from repro_torch.models.transformer import param_shapes
shape = tuple(int(x) for x in sys.argv[1].split(","))
axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
mesh = init_fake_mesh(shape, axes)
n = 0
for arch in T.list_archs():
    cfg = T.get_config(arch)
    shapes = param_shapes(cfg)
    for mode in ("train", "serve", "fsdp"):
        specs = pytree.tree_leaves(TS.param_specs(shapes, mesh, mode, cfg),
                                   is_leaf=lambda x: isinstance(x, tuple))
        for t, spec in zip(pytree.tree_leaves(shapes), specs):
            local = distribute_tensor(t, mesh, list(TS.to_placements(
                spec, mesh)), src_data_rank=None).to_local()
            want = tuple(
                -(-n // math.prod(mesh.shape[mesh.mesh_dim_names.index(a)]
                                  for a in ((e,) if isinstance(e, str)
                                            else (e or ()))))
                for n, e in zip(t.shape, spec))
            assert tuple(local.shape) == want, (arch, mode, spec, local.shape)
            n += 1
print("checked", n)
"""


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_local_shapes_on_fake_mesh(mesh_name):
    """Rank 0 of a fake 256- or 512-rank process group holds, for every
    leaf of every config in every mode, the shard the spec implies."""
    shape = ",".join(map(str, MESHES[mesh_name][0]))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _LOCAL_SHAPES, shape],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "checked" in out.stdout
