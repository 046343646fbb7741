"""The plain versions of the unit's kernels on the CPU, against the JAX
package: K9 (the residual add with the next RMSNorm) and K10 (the SwiGLU
gate), each forward and backward; their routes; the models' deferred
residual (each branch output added by the next layer's norm) against the
old per-layer order; and ``ops.add_rmsnorm`` / ``ops.swiglu_gate`` on gloo
meshes.

Inputs are made with NumPy from a seed and handed to both packages; bf16
inputs are rounded to bf16 first and the references take the same values.
Tolerances:

- K9's sum ``s = x + h``: bit for bit (one rounded add in both);
- forwards in float32: 1e-6 relative L2 (the same float32 ops; the mean
  of squares is summed in another order);
- forwards in bf16: one bf16 ulp (2^-8 relative) of the largest output,
  as the two frameworks round intermediates at different places;
- backwards in float32: 1e-5 relative L2 against ``jax.vjp`` (the same
  float32 algebra, sums over rows in other orders) and against torch
  autograd of the plain forward;
- backwards of bf16 inputs: 2e-2 relative L2 against ``jax.vjp`` on the
  same rounded values (K9's plain backward keeps float32 and rounds the
  norm's gradient once, XLA at every op), 1e-2 against torch autograd;
  K10's plain backward is autograd's own ops: bit for bit;
- the deferred residual against the old order, and ``ops`` on a 1 x 1 mesh
  against no mesh: bit for bit (the same ops in the same order); on two
  ranks the rows are bit for bit and ``scale``'s gradient, a sum over the
  ranks' rows, within 1e-6 relative L2.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.models.layers import rmsnorm as j_rmsnorm
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels import swiglu_gate as K10
from repro_torch.kernels import unit_norm as K9
from repro_torch.models import transformer as T
from repro_torch.models.layers import mlp_apply, rmsnorm

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
FWD_REL = 1e-6
BWD_JAX = {"f32": 1e-5, "bf16": 2e-2}
BWD_AUTOGRAD = {"f32": 1e-5, "bf16": 1e-2}
ULP = 2.0 ** -8


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(dt: str, shape, n: int, seed: int = 0):
    """``n`` arrays of ``shape`` rounded to the type, as torch and JAX."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    return ts, [jnp.asarray(_np(t)).astype(jdt) for t in ts]


def _forward_close(dt: str, got, want) -> None:
    got, want = _np(got), _np(want)
    if dt == "f32":
        assert _rel(got, want) <= FWD_REL
    else:
        assert np.abs(got - want).max() <= ULP * np.abs(want).max()


# ---------------------------------------------------------------------------
# K9: the residual add and RMSNorm
# ---------------------------------------------------------------------------

SHAPES = [(2, 5, 64), (3, 7, 40), (1, 1, 96)]


def _scale(w: int) -> torch.Tensor:
    rng = np.random.default_rng(7)
    return torch.from_numpy((1 + 0.1 * rng.standard_normal(w))
                            .astype(np.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_add_rmsnorm_plain_matches_repro(dt, shape):
    """``s = x + h`` and ``rmsnorm(s, scale)`` against ``repro``'s add and
    ``rmsnorm``; without ``h`` the norm alone."""
    (x, h), (jx, jh) = _inputs(dt, shape, 2)
    scale = _scale(shape[-1])
    s, y = K9.add_rmsnorm_plain(x, h, scale)
    js = jx + jh
    assert np.array_equal(_np(s), _np(js))
    _forward_close(dt, y, j_rmsnorm(js, jnp.asarray(scale.numpy())))
    s0, y0 = K9.add_rmsnorm_plain(x, None, scale)
    assert s0 is x
    _forward_close(dt, y0, j_rmsnorm(jx, jnp.asarray(scale.numpy())))
    assert torch.equal(y0, rmsnorm(x, scale))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_ds", [True, False])
def test_add_rmsnorm_backward_plain_matches_jax_vjp(dt, shape, with_ds):
    """``d`` (the gradient of ``x`` and of ``h``) and ``dscale`` against
    ``jax.vjp`` of ``(x + h, rmsnorm(x + h, scale))`` from the cotangents
    of ``y`` and (``with_ds``) of ``s``."""
    (x, h, dy, ds), (jx, jh, jdy, jds) = _inputs(dt, shape, 4, seed=1)
    scale = _scale(shape[-1])
    s, _ = K9.add_rmsnorm_plain(x, h, scale)
    d, dscale = K9.add_rmsnorm_backward_plain(dy, ds if with_ds else None, s,
                                              scale)

    def fn(a, b, sc):
        t = a + b
        return t, j_rmsnorm(t, sc)
    _, vjp = jax.vjp(fn, jx, jh, jnp.asarray(scale.numpy()))
    jd, jdh, jdscale = vjp((jds if with_ds else jnp.zeros_like(jds), jdy))
    assert _rel(_np(d), _np(jd)) <= BWD_JAX[dt]
    assert np.array_equal(_np(jd), _np(jdh))
    assert _rel(dscale.numpy(), _np(jdscale)) <= BWD_JAX[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_add_rmsnorm_backward_plain_matches_autograd(dt, shape):
    """The plain backward against torch autograd of the plain forward, and
    the ``AddRMSNorm`` route's shape of the gradients: the same ``d`` for
    ``x`` and ``h``."""
    (x, h, dy, ds), _ = _inputs(dt, shape, 4, seed=2)
    scale = _scale(shape[-1])
    leaves = [t.clone().requires_grad_() for t in (x, h, scale)]
    s, y = K9.add_rmsnorm_plain(*leaves)
    torch.autograd.backward((s, y), (ds, dy))
    d, dscale = K9.add_rmsnorm_backward_plain(dy, ds, s.detach(), scale)
    assert torch.equal(leaves[0].grad, leaves[1].grad)
    assert _rel(_np(d), _np(leaves[0].grad)) <= BWD_AUTOGRAD[dt]
    assert _rel(dscale.numpy(), leaves[2].grad.numpy()) <= BWD_AUTOGRAD[dt]
    rstd = K9.rstd_plain(s.detach())
    assert torch.equal(
        K9.add_rmsnorm_backward_plain(dy, ds, s.detach(), scale, rstd)[0], d)


# ---------------------------------------------------------------------------
# K10: the SwiGLU gate
# ---------------------------------------------------------------------------


def _j_gate(g, u):
    return jax.nn.silu(g.astype(jnp.float32)).astype(u.dtype) * u


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 5, 88), (1, 1, 44), (3, 33)])
def test_swiglu_gate_plain_matches_repro(dt, shape):
    """The gate and its gradients against ``repro``'s ``swiglu`` gate and
    ``jax.vjp`` of it; the plain backward against torch autograd of the
    plain forward, bit for bit (the same ops)."""
    (g, u, dh), (jg, ju, jdh) = _inputs(dt, shape, 3, seed=3)
    g = g * 3
    jg = jnp.asarray(_np(g)).astype(DTYPES[dt][1])
    _forward_close(dt, K10.swiglu_gate_plain(g, u), _j_gate(jg, ju))
    dg, du = K10.swiglu_gate_backward_plain(dh, g, u)
    _, vjp = jax.vjp(_j_gate, jg, ju)
    jdg, jdu = vjp(jdh)
    assert _rel(_np(dg), _np(jdg)) <= BWD_JAX[dt]
    assert _rel(_np(du), _np(jdu)) <= BWD_JAX[dt]
    leaves = [t.clone().requires_grad_() for t in (g, u)]
    K10.swiglu_gate_plain(*leaves).backward(dh)
    assert torch.equal(dg, leaves[0].grad) and torch.equal(du,
                                                           leaves[1].grad)
    assert dg.dtype == g.dtype and du.dtype == u.dtype


def test_swiglu_uses_the_gate():
    """``layers.swiglu`` on the CPU is the JAX package's gate between the
    products, bit for bit the ops it ran before."""
    (x,), _ = _inputs("bf16", (2, 3, 16), 1, seed=4)
    (wg, wu, wd), _ = _inputs("bf16", (16, 16), 3, seed=5)
    g, u = x @ wg, x @ wu
    want = (torch.nn.functional.silu(g.float()).to(x.dtype) * u) @ wd
    got = mlp_apply({"w_gate": wg, "w_up": wu, "w_down": wd}, x)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# routes and devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [K9, K10])
def test_route_picks_vectors_only_for_whole_aligned_vectors(mod):
    """16-byte vectors where the width (K10: the size) is whole vectors of
    the type and every tensor starts on a 16-byte boundary; else the
    scalar route."""
    for dtype, e in ((torch.bfloat16, 8), (torch.float32, 4)):
        a = torch.zeros(4 * e * 8, dtype=dtype)
        assert mod.route(4 * e, dtype, [a]) == "vector"
        assert mod.route(4 * e + 2, dtype, [a]) == "scalar"
        assert mod.route(4 * e, dtype, [a, a[1:]]) == "scalar"
        assert mod.route(4 * e, dtype, [a[e:]]) == "vector"
    assert K9.max_width(torch.bfloat16) == 16384
    assert K9.max_width(torch.float32) == 8192


def test_meta_and_cpu_take_the_plain_versions():
    """Meta tensors (the dry run's) propagate shapes through the plain
    versions; CPU tensors give the plain versions' values; nothing counts
    as a launch."""
    K9.reset_counts()
    K10.reset_counts()
    x = torch.empty(2, 3, 64, dtype=torch.bfloat16, device="meta")
    sc = torch.empty(64, device="meta")
    s, y = ops.add_rmsnorm(x, x, sc)
    assert s.shape == y.shape == x.shape and y.device.type == "meta"
    g = torch.empty(2, 3, 48, dtype=torch.bfloat16, device="meta")
    assert ops.swiglu_gate(g, g).shape == g.shape
    (xc, hc), _ = _inputs("bf16", (2, 3, 64), 2)
    sc = _scale(64)
    s, y = ops.add_rmsnorm(xc, hc, sc)
    ps, py = K9.add_rmsnorm_plain(xc, hc, sc)
    assert torch.equal(s, ps) and torch.equal(y, py)
    assert K9.LAUNCHES == K9.BWD_LAUNCHES == K10.LAUNCHES == 0


# ---------------------------------------------------------------------------
# the deferred residual against the old per-layer order
# ---------------------------------------------------------------------------


def _old_ffn(p, cfg, ffn, x):
    if ffn == "none":
        return x, None
    h = rmsnorm(x, p["norm2"])
    if ffn == "moe":
        h, aux = T.moe_apply(p["mlp"], cfg.moe, h)
        return x + h, aux
    return x + mlp_apply(p["mlp"], h), None


def _old_layer(p, cfg, spec, x, positions):
    mixer, ffn = spec
    h = rmsnorm(x, p["norm1"])
    if mixer == "mamba":
        h = T.mamba_forward(p["mixer"], cfg.mamba, h)
    elif mixer == "mla":
        h = T.mla_forward(p["mixer"], cfg.mixer_cfg(mixer), h, positions)
    else:
        h = T.gqa_forward(p["mixer"], cfg.mixer_cfg(mixer), h, positions)
    return _old_ffn(p, cfg, ffn, x + h)


def _old_loss(params, cfg, batch):
    """``loss_fn`` as the stack ran before the add moved into the next
    norm: each layer adds its branch outputs at its end."""
    x = T.embed_tokens(params, cfg, batch["tokens"],
                       batch.get("prefix_embeddings"))
    positions = torch.arange(x.shape[1])
    aux_total = torch.zeros(())

    def unit(up, xx):
        a = torch.zeros(())
        for p, spec in zip(up, cfg.pattern):
            xx, aux = _old_layer(p, cfg, spec, xx, positions)
            if aux is not None:
                a = a + aux
        return xx, a
    for p, spec in zip(params["prelude"], cfg.prelude):
        x, aux = _old_layer(p, cfg, spec, x, positions)
        if aux is not None:
            aux_total = aux_total + aux
    unit_fn = T._remat_wrap(unit, cfg)
    for up in params["units"]:
        x, aux = unit_fn(up, x)
        aux_total = aux_total + aux
    x = rmsnorm(x, params["final_norm"])
    logits = T.logits_fn(params, cfg, x)
    if cfg.n_prefix:
        logits = logits[:, cfg.n_prefix:]
    loss = T.cross_entropy_loss(logits, batch["labels"])
    total = loss + cfg.aux_loss_weight * aux_total
    if cfg.mtp and "mtp" in params:
        mtp, labels = params["mtp"], batch["labels"]
        emb_next = T._lookup(params["embed"], labels)
        h = torch.cat([x, emb_next.to(x.dtype)], dim=-1) @ mtp["in_proj"]
        pos = torch.arange(h.shape[1])
        h, _ = _old_layer(mtp["layer"], cfg, cfg.pattern[-1], h, pos)
        h = rmsnorm(h, mtp["norm"])
        lab2 = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        total = total + cfg.mtp_loss_weight * T.cross_entropy_loss(
            T.logits_fn(params, cfg, h)[:, :-1], lab2[:, :-1])
    return total


def _old_serve(params, cfg, tokens, pe, max_len, steps: int):
    """``prefill`` then ``steps`` greedy ``decode_step`` calls in the old
    order; the logits of each."""
    x = T.embed_tokens(params, cfg, tokens, pe)
    s = x.shape[1]
    positions = torch.arange(s)
    caches = {"prelude": [], "units": []}

    def pre(p, spec, x):
        mixer, ffn = spec
        h = rmsnorm(x, p["norm1"])
        if mixer == "mamba":
            h, c = T.mamba_prefill(p["mixer"], cfg.mamba, h)
        elif mixer == "mla":
            h, c = T.mla_prefill(p["mixer"], cfg.mixer_cfg(mixer), h,
                                 positions)
        else:
            h, c = T.gqa_prefill(p["mixer"], cfg.mixer_cfg(mixer), h,
                                 positions)
        return _old_ffn(p, cfg, ffn, x + h)[0], T._pad_cache(c, max_len)
    for p, spec in zip(params["prelude"], cfg.prelude):
        x, c = pre(p, spec, x)
        caches["prelude"].append(c)
    for up in params["units"]:
        row = []
        for p, spec in zip(up, cfg.pattern):
            x, c = pre(p, spec, x)
            row.append(c)
        caches["units"].append(row)
    x = rmsnorm(x, params["final_norm"])
    logits = T.logits_fn(params, cfg, x[:, -1:])[:, 0]
    out = [logits]

    def dec(p, spec, x, cache, n):
        mixer, ffn = spec
        h = rmsnorm(x, p["norm1"])
        if mixer == "mamba":
            h, cache = T.mamba_decode(p["mixer"], cfg.mamba, h, cache)
        elif mixer == "mla":
            h, cache = T.mla_decode(p["mixer"], cfg.mixer_cfg(mixer), h,
                                    cache, n)
        else:
            h, cache = T.gqa_decode(p["mixer"], cfg.mixer_cfg(mixer), h,
                                    cache, n)
        return _old_ffn(p, cfg, ffn, x + h)[0], cache
    n = s
    for _ in range(steps):
        x = T._embed(params, cfg, logits.argmax(-1))[:, None, :]
        for i, (p, spec) in enumerate(zip(params["prelude"], cfg.prelude)):
            x, caches["prelude"][i] = dec(p, spec, x, caches["prelude"][i],
                                          n)
        for up, row in zip(params["units"], caches["units"]):
            for i, (p, spec) in enumerate(zip(up, cfg.pattern)):
                x, row[i] = dec(p, spec, x, row[i], n)
        logits = T.logits_fn(params, cfg, rmsnorm(x, params["final_norm"]))[
            :, 0]
        out.append(logits)
        n += 1
    return out


ARCHS = ["yi-6b", "mamba2-1.3b", "jamba-1.5-large-398b", "deepseek-v3-671b",
         "paligemma-3b"]


def _model(arch: str, dt: str):
    cfg = get_reduced_config(arch)
    if dt == "f32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = T.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    rng = np.random.default_rng(2)
    b, s = 2, 12
    shape = (b, s) if cfg.codebooks == 1 else (b, s, cfg.codebooks)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, shape))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, shape))
    pe = torch.from_numpy(rng.standard_normal(
        (b, cfg.n_prefix, cfg.d_model)).astype(np.float32)).to(cfg.dtype) \
        if cfg.n_prefix else None
    return cfg, params, tokens, labels, pe


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_deferred_residual_loss_and_gradients_bitwise(arch, dt):
    """``loss_fn`` and every parameter's gradient, bit for bit the old
    per-layer order's (the MTP loss and the MoE aux loss included)."""
    cfg, params, tokens, labels, pe = _model(arch, dt)
    batch = {"tokens": tokens, "labels": labels}
    if pe is not None:
        batch["prefix_embeddings"] = pe
    leaves = [t for t in pytree.tree_leaves(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_()
    new = T.loss_fn(params, cfg, batch)[0]
    g_new = torch.autograd.grad(new, leaves, allow_unused=True)
    old = _old_loss(params, cfg, batch)
    g_old = torch.autograd.grad(old, leaves, allow_unused=True)
    assert torch.equal(new, old)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(g_new, g_old))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_deferred_residual_prefill_and_decode_bitwise(arch, dt):
    """``prefill`` and three ``decode_step`` calls, bit for bit the old
    per-layer order's logits."""
    cfg, params, tokens, _, pe = _model(arch, dt)
    max_len = tokens.shape[1] + cfg.n_prefix + 4
    with torch.no_grad():
        want = _old_serve(params, cfg, tokens, pe, max_len, 3)
        logits, caches, n = T.prefill(params, cfg, tokens, pe,
                                      max_len=max_len)
        got = [logits]
        for _ in range(3):
            logits, caches = T.decode_step(params, cfg, logits.argmax(-1),
                                           caches, n)
            got.append(logits)
            n += 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# gloo meshes
# ---------------------------------------------------------------------------

_WORKER = r"""
import json, os, sys
from datetime import timedelta
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
tmp = os.environ["CASES_DIR"]
dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{world}",
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=300))
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import distribute_tensor
from repro_torch.kernels import ops
from repro_torch.kernels import swiglu_gate as K10
from repro_torch.kernels import unit_norm as K9
from repro_torch.launch.mesh import make_mesh

gen = torch.Generator().manual_seed(5)
b, s, d, f = 4, 6, 64, 96


def rnd(*shape):
    return torch.randn(*shape, generator=gen)


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


out = {}
for shape in ([(1, 1)] if world == 1 else [(2, 1), (1, 2)]):
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    act = (Shard(0), Replicate())
    x, h, dy, ds, sc = rnd(b, s, d), rnd(b, s, d), rnd(b, s, d), \
        rnd(b, s, d), 1 + 0.1 * rnd(d)
    leaves = [distribute_tensor(t.clone(), mesh, pl).requires_grad_()
              for t, pl in ((x, act), (h, act),
                            (sc, (Replicate(), Replicate())))]
    sd, yd = ops.add_rmsnorm(*leaves)
    torch.autograd.backward((sd, yd), (distribute_tensor(ds, mesh, act),
                                       distribute_tensor(dy, mesh, act)))
    ref = [t.clone().requires_grad_() for t in (x, h, sc)]
    rs, ry = K9.add_rmsnorm_plain(*ref)
    torch.autograd.backward((rs, ry), (ds, dy))
    y0 = ops.add_rmsnorm(leaves[0].detach(), None, leaves[2].detach())[1]
    gact = (Shard(0), Shard(2))
    g, u, dh = rnd(b, s, f), rnd(b, s, f), rnd(b, s, f)
    gl = [distribute_tensor(t.clone(), mesh, gact).requires_grad_()
          for t in (g, u)]
    hd = ops.swiglu_gate(*gl)
    hd.backward(distribute_tensor(dh, mesh, gact))
    gref = [t.clone().requires_grad_() for t in (g, u)]
    rh = K10.swiglu_gate_plain(*gref)
    rh.backward(dh)
    key = ",".join(map(str, shape))
    out[key] = {
        "s": torch.equal(full(sd), rs), "y": torch.equal(full(yd), ry),
        "y_without_h": torch.equal(full(y0), K9.rmsnorm_plain(x, sc)),
        "dx": torch.equal(full(leaves[0].grad), ref[0].grad),
        "dh": torch.equal(full(leaves[1].grad), ref[1].grad),
        "dscale_bitwise": torch.equal(full(leaves[2].grad), ref[2].grad),
        "dscale_rel": float((full(leaves[2].grad) - ref[2].grad).norm()
                            / ref[2].grad.norm()),
        "gate": torch.equal(full(hd), rh),
        "dg": torch.equal(full(gl[0].grad), gref[0].grad),
        "du": torch.equal(full(gl[1].grad), gref[1].grad),
        "gate_split_over_model": hd.placements[1].is_shard(2)}
if rank == 0:
    with open(f"{tmp}/result_{world}.json", "w") as fh:
        json.dump(out, fh)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One gloo group of one rank (a 1 x 1 mesh) and one of two ranks
    ((2, 1) and (1, 2) meshes), at once."""
    tmp = tmp_path_factory.mktemp("unit_gloo")
    env = dict(os.environ, PYTHONPATH=str(SRC), CASES_DIR=str(tmp),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER],
                              env=dict(env, RANK=str(r), WORLD=str(w)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for w in (1, 2) for r in range(w)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            if p.returncode != 0:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not errs, errs[0]
    out = {}
    for w in (1, 2):
        with open(tmp / f"result_{w}.json") as fh:
            out.update(json.load(fh))
    return out


def test_ops_on_a_one_by_one_mesh_are_bitwise_no_mesh(mesh_runs):
    """On a 1 x 1 mesh ``ops.add_rmsnorm`` (with and without ``h``) and
    ``ops.swiglu_gate`` give the single device's plain results and
    gradients bit for bit."""
    r = mesh_runs["1,1"]
    assert all(r[k] for k in ("s", "y", "y_without_h", "dx", "dh",
                              "dscale_bitwise", "gate", "dg", "du")), r


@pytest.mark.parametrize("mesh", ["2,1", "1,2"])
def test_ops_on_two_ranks_match_one_device(mesh_runs, mesh):
    """On two gloo ranks (batch over ``data``, or the gate's d_ff over
    ``model``) the rows and the gate bit for bit one device's; ``scale``'s
    gradient, summed over the ranks' rows, within 1e-6."""
    r = mesh_runs[mesh]
    assert all(r[k] for k in ("s", "y", "y_without_h", "dx", "dh", "gate",
                              "dg", "du")), r
    assert r["dscale_rel"] <= 1e-6, r
    if mesh == "1,2":
        assert r["gate_split_over_model"], r


# ---------------------------------------------------------------------------
# the card run's counts of K9 and K10 calls
# ---------------------------------------------------------------------------

ALL_ARCHS = ["yi-6b", "gemma3-27b", "starcoder2-7b", "stablelm-12b",
             "mamba2-1.3b", "jamba-1.5-large-398b", "deepseek-v3-671b",
             "arctic-480b", "musicgen-large", "paligemma-3b"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_chip_smoke_counts_the_calls_the_models_make(arch, monkeypatch):
    """``chip_smoke.unit_calls`` and ``step_calls`` (which gate the card
    run's launches) count the ``ops.add_rmsnorm`` and ``ops.swiglu_gate``
    calls a reduced model makes: a prefill and a decode step each
    ``unit_calls(cfg)["serve"]``, a train step's forward with the remat
    recompute ``step_calls``' K9 and K10."""
    sys.path.insert(0, str(SRC.parent))
    import chip_smoke
    calls = {"K9": 0, "K10": 0}

    def counted(name, key):
        inner = getattr(ops, name)

        def fn(*a, **kw):
            calls[key] += 1
            return inner(*a, **kw)
        monkeypatch.setattr(ops, name, fn)
    counted("add_rmsnorm", "K9")
    counted("swiglu_gate", "K10")
    cfg, params, tokens, labels, pe = _model(arch, "f32")
    serve = chip_smoke.unit_calls(cfg)["serve"]
    with torch.no_grad():
        logits, caches, n = T.prefill(params, cfg, tokens, pe,
                                      max_len=tokens.shape[1] + cfg.n_prefix
                                      + 2)
        assert calls == serve
        calls.update(K9=0, K10=0)
        T.decode_step(params, cfg, logits.argmax(-1), caches, n)
        assert calls == serve
    calls.update(K9=0, K10=0)
    batch = {"tokens": tokens, "labels": labels}
    if pe is not None:
        batch["prefix_embeddings"] = pe
    leaves = [t for t in pytree.tree_leaves(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_()
    total = T.loss_fn(params, cfg, batch)[0]
    torch.autograd.grad(total, leaves, allow_unused=True)
    step = chip_smoke.step_calls(cfg)
    assert calls == {"K9": step["K9"], "K10": step["K10"]}
    assert step["K9_backward"] == chip_smoke.unit_calls(cfg)["K9_units"] + \
        chip_smoke.unit_calls(cfg)["K9_rest"]
