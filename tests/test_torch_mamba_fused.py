"""The plain versions of the Mamba block's kernels on the CPU, against the
JAX package: K6 (the causal conv with its SiLU), K7 (the D skip with the
gated norm) and K8 (the decode's state step), each forward and (K6, K7)
backward, and the reduced models' prefill and decode through them.

Inputs are made with NumPy from a seed and handed to both packages; bf16
inputs are rounded to bf16 first and the references take the same values.
Tolerances:

- forwards in float32: 1e-6 relative L2 (the same float32 ops; XLA may
  contract a multiply and an add into one FMA);
- forwards in bf16: one bf16 ulp (2^-8 relative) of the largest output,
  as the two frameworks round intermediates at different places;
- backwards in float32: 1e-5 relative L2 against ``jax.vjp`` (the same
  float32 algebra, sums over batch and sequence in other orders) and
  against torch autograd of the plain forward;
- backwards of bf16 inputs: 2e-2 relative L2 against the float32
  references on the same rounded values (the port's plain backward
  keeps float32 throughout and rounds its outputs once; autograd rounds at
  every op);
- whole layers and models: ``tests/test_torch_models.py``'s, float32 1e-5,
  bf16 3e-2 absolute on logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as repro_config
from repro.models import mamba as jmamba
from repro.models import transformer as JT
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import gated_norm as K7
from repro_torch.kernels import mamba_conv as K6
from repro_torch.kernels import mamba_decode as K8
from repro_torch.kernels import ops
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as TT

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
BWD_TOL = {"f32": 1e-5, "bf16": 2e-2}
K = 4


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _arrays(seed, dtype: str, **shapes) -> dict:
    """Normal float32 arrays (scaled by the shape's third item), rounded to
    ``dtype`` where the shape's fourth item says so."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, scale, shift, rounded) in shapes.items():
        a = (rng.normal(size=shape) * scale + shift).astype(np.float32)
        if rounded:
            a = torch.from_numpy(a).to(DTYPES[dtype][0]).float().numpy()
        out[name] = a
    return out


def _t(a, dtype: str, rounded: bool = True) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t.to(DTYPES[dtype][0]) if rounded else t


def _j(a, dtype: str, rounded: bool = True):
    return jnp.asarray(a).astype(DTYPES[dtype][1] if rounded
                                 else jnp.float32)


def _forward_close(got, want, dtype: str) -> None:
    got, want = _np(got), _np(want)
    if dtype == "f32":
        assert _rel(got, want) <= 1e-6
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0 ** -8 * np.abs(want).max())


# ---------------------------------------------------------------------------
# K6: the causal conv with its SiLU
# ---------------------------------------------------------------------------

def _conv_inputs(seed, dtype, b=2, s=37, c=128, with_state=False):
    shapes = {"x": ((b, s, c), 1.0, 0.0, True),
              "w": ((K, c), 0.3, 0.0, True), "b": ((c,), 0.1, 0.0, True),
              "g": ((b, s, c), 1.0, 0.0, True)}
    if with_state:
        shapes["state"] = ((b, K - 1, c), 1.0, 0.0, True)
    return _arrays(seed, dtype, **shapes)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 37])
def test_conv_plain_matches_repro(dtype, with_state, s):
    a = _conv_inputs(0, dtype, s=s, with_state=with_state)
    st = a.get("state")
    jy, jst = jmamba._causal_conv(_j(a["x"], dtype), _j(a["w"], dtype),
                                  _j(a["b"], dtype),
                                  None if st is None else _j(st, dtype))
    ty, tst = K6.causal_conv_plain(_t(a["x"], dtype), _t(a["w"], dtype),
                                   _t(a["b"], dtype),
                                   None if st is None else _t(st, dtype))
    assert ty.dtype == DTYPES[dtype][0] and ty.shape == jy.shape
    _forward_close(ty, jy, dtype)
    np.testing.assert_array_equal(_np(tst), _np(jst))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 2, 5, 37])
def test_conv_backward_plain_matches_jax_vjp_and_autograd(dtype, s):
    a = _conv_inputs(1, dtype, s=s)
    dx, dw, db = K6.causal_conv_backward_plain(
        _t(a["x"], dtype), _t(a["w"], dtype), _t(a["b"], dtype),
        _t(a["g"], dtype))
    assert (dx.dtype, dw.dtype, db.dtype) == (DTYPES[dtype][0],) * 3
    # float32 references on the same (rounded) values
    _, vjp = jax.vjp(lambda x, w, b: jmamba._causal_conv(x, w, b)[0],
                     *(jnp.asarray(a[k]) for k in ("x", "w", "b")))
    want = vjp(jnp.asarray(a["g"]))
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in
              ("x", "w", "b")]
    K6.causal_conv_plain(*leaves)[0].backward(torch.from_numpy(a["g"]))
    for got, jw, tw in zip((dx, dw, db), want, leaves):
        assert got.shape == tw.shape == jw.shape
        assert _rel(_np(got), _np(jw)) <= BWD_TOL[dtype]
        assert _rel(_np(got), tw.grad.numpy()) <= BWD_TOL[dtype]


def test_conv_backward_plain_dx_is_autograds_in_float32():
    """dx sums the K products in the kernel's order; in float32 it is
    autograd's to the last few ulps (autograd adds the same terms in
    another order)."""
    a = _conv_inputs(2, "f32", s=64, c=16)
    dx = K6.causal_conv_backward_plain(*(torch.from_numpy(a[k]) for k in
                                         ("x", "w", "b", "g")))[0]
    x = torch.from_numpy(a["x"]).requires_grad_()
    K6.causal_conv_plain(x, torch.from_numpy(a["w"]),
                         torch.from_numpy(a["b"]))[0].backward(
        torch.from_numpy(a["g"]))
    torch.testing.assert_close(dx, x.grad, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("want_state", [False, True])
def test_ops_conv_covers_three_segments_on_the_cpu(want_state):
    """``ops.causal_conv`` over xs, B, C as the model calls it: each
    segment is the plain conv, and the new states are the last K-1 rows of
    each padded input (zeros ahead of the sequence)."""
    segs = [_conv_inputs(3 + j, "f32", s=2, c=c) for j, c in
            enumerate((32, 8, 8))]
    xs = [torch.from_numpy(a["x"]) for a in segs]
    ws = [torch.from_numpy(a["w"]) for a in segs]
    bs = [torch.from_numpy(a["b"]) for a in segs]
    ys, new = ops.causal_conv(xs, ws, bs, want_state=want_state)
    for x, w, b, y in zip(xs, ws, bs, ys):
        assert torch.equal(y, K6.causal_conv_plain(x, w, b)[0])
    if not want_state:
        assert new is None
        return
    for x, st in zip(xs, new):
        want = torch.cat([torch.zeros_like(x[:, :1]), x], 1)
        assert torch.equal(st, want)


# ---------------------------------------------------------------------------
# K7: the D skip and the gated norm
# ---------------------------------------------------------------------------

def _norm_inputs(seed, dtype, b=2, s=9, h=8, p=16):
    di = h * p
    return _arrays(seed, dtype, y=((b, s, di), 1.0, 0.0, True),
                   xs=((b, s, di), 1.0, 0.0, True),
                   z=((b, s, di), 1.0, 0.0, True),
                   D=((h,), 0.1, 1.0, False), scale=((di,), 0.1, 1.0, False),
                   dout=((b, s, di), 1.0, 0.0, True))


def _repro_norm(y, xs, z, D, scale):
    """The JAX package's D skip and ``_gated_norm`` (models/mamba.py:210,
    :218), over [B, S, H, P] heads as it computes them."""
    b, s, di = y.shape
    h = D.shape[0]
    y4 = y.reshape(b, s, h, di // h) + xs.reshape(b, s, h, di // h) * \
        D[None, None, :, None].astype(xs.dtype)
    return jmamba._gated_norm(y4.reshape(b, s, di), z, scale)


def _plain_norm(a, dtype, rounded=True):
    return K7.gated_norm_plain(
        *(_t(a[k], dtype, rounded) for k in ("y", "xs", "z")),
        torch.from_numpy(a["D"]), torch.from_numpy(a["scale"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 9, 8, 16), (1, 1, 8, 16),
                                   (1, 3, 2, 64)])
def test_norm_plain_matches_repro(dtype, shape):
    a = _norm_inputs(4, dtype, *shape)
    want = _repro_norm(*(_j(a[k], dtype) for k in ("y", "xs", "z")),
                       jnp.asarray(a["D"]), jnp.asarray(a["scale"]))
    got = _plain_norm(a, dtype)
    assert got.dtype == DTYPES[dtype][0]
    _forward_close(got, want, dtype)


def test_norm_plain_without_skip_is_gated_norm():
    a = _norm_inputs(5, "f32")
    got = K7.gated_norm_plain(torch.from_numpy(a["y"]), None,
                              torch.from_numpy(a["z"]), None,
                              torch.from_numpy(a["scale"]))
    want = jmamba._gated_norm(*(jnp.asarray(a[k]) for k in
                                ("y", "z", "scale")))
    assert _rel(_np(got), _np(want)) <= 1e-6


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norm_plain_keeps_the_models_bits(dtype):
    """The skip over [..., H * P] rows and the norm are the model's former
    ops on [B, S, H, P] heads bit for bit, forward and gradients (so the
    model on the CPU keeps its bits)."""
    a = _norm_inputs(6, dtype)
    b, s, di = a["y"].shape
    h = a["D"].shape[0]

    def leaves():
        return ([_t(a[k], dtype).requires_grad_() for k in ("y", "xs", "z")]
                + [torch.from_numpy(a[k]).requires_grad_()
                   for k in ("D", "scale")])
    new, old = leaves(), leaves()
    got = K7.gated_norm_plain(*new)
    y, xs, z, D, scale = old
    y4 = y.reshape(b, s, h, -1) + xs.reshape(b, s, h, -1) * \
        D[None, None, :, None].to(xs.dtype)
    want = tmamba._gated_norm(y4.reshape(b, s, di), z, scale)
    assert torch.equal(got, want)
    dout = _t(a["dout"], dtype)
    got.backward(dout)
    want.backward(dout)
    for n_, o_ in zip(new, old):
        assert torch.equal(n_.grad, o_.grad)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 9, 8, 16), (1, 3, 2, 64)])
def test_norm_backward_plain_matches_jax_vjp_and_autograd(dtype, shape):
    a = _norm_inputs(7, dtype, *shape)
    got = K7.gated_norm_backward_plain(
        *(_t(a[k], dtype) for k in ("dout", "y", "xs", "z")),
        torch.from_numpy(a["D"]), torch.from_numpy(a["scale"]))
    assert [t.dtype for t in got] == [DTYPES[dtype][0]] * 3 + \
        [torch.float32] * 2
    names = ("y", "xs", "z", "D", "scale")
    _, vjp = jax.vjp(_repro_norm, *(jnp.asarray(a[k]) for k in names))
    want = vjp(jnp.asarray(a["dout"]))
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in names]
    K7.gated_norm_plain(*leaves).backward(torch.from_numpy(a["dout"]))
    for g, jw, tw in zip(got, want, leaves):
        assert _rel(_np(g), _np(jw)) <= BWD_TOL[dtype]
        assert _rel(_np(g), tw.grad.numpy()) <= BWD_TOL[dtype]


def test_norm_backward_plain_takes_the_forwards_rstd():
    """Given the forward's rstd (as the kernel's backward is) the plain
    backward is the one that recomputes it."""
    a = _norm_inputs(8, "f32")
    args = [torch.from_numpy(a[k]) for k in ("dout", "y", "xs", "z", "D",
                                             "scale")]
    r = K7.rstd_plain(args[1], args[2], args[3], args[4])
    assert r.shape == (*a["y"].shape[:-1], 1)
    for g, w in zip(K7.gated_norm_backward_plain(*args, rstd=r),
                    K7.gated_norm_backward_plain(*args)):
        assert torch.equal(g, w)


def test_norm_wrapper_on_the_cpu_is_the_plain_version():
    a = _norm_inputs(9, "bf16")
    ins = [_t(a[k], "bf16") for k in ("y", "xs", "z")]
    out, rstd = K7.gated_norm(*ins, torch.from_numpy(a["D"]),
                              torch.from_numpy(a["scale"]))
    assert rstd is None
    assert torch.equal(out, _plain_norm(a, "bf16"))
    assert torch.equal(ops.gated_norm(*ins, torch.from_numpy(a["D"]),
                                      torch.from_numpy(a["scale"])), out)


def test_wrappers_on_meta_tensors_give_shapes():
    """The dry run's meta tensors take the plain versions."""
    m = torch.device("meta")
    x = torch.empty(2, 5, 32, device=m, dtype=torch.bfloat16)
    w = torch.empty(K, 32, device=m, dtype=torch.bfloat16)
    b = torch.empty(32, device=m, dtype=torch.bfloat16)
    ys, new = ops.causal_conv([x], [w], [b], want_state=True)
    assert ys[0].shape == x.shape and new[0].shape == (2, K - 1, 32)
    D = torch.empty(4, device=m)
    scale = torch.empty(32, device=m)
    assert ops.gated_norm(x, x, x, D, scale).shape == x.shape
    bf = dict(device=m, dtype=torch.bfloat16)
    states = [torch.empty(2, K - 1, c, **bf) for c in (32, 16, 16)]
    ssm = torch.empty(2, 4, 16, 8, device=m)
    y, got_states, got_ssm = ops.decode_layer(
        torch.empty(2, 1, 32, **bf), torch.empty(2, 1, 16, **bf),
        torch.empty(2, 1, 16, **bf), torch.empty(2, 1, 4, **bf),
        [torch.empty(K, c, **bf) for c in (32, 16, 16)],
        [torch.empty(c, **bf) for c in (32, 16, 16)], states, ssm, D, D, D)
    assert y.shape == (2, 4, 8) and got_ssm is ssm
    assert all(a is b for a, b in zip(got_states, states))


# ---------------------------------------------------------------------------
# K8: the decode layer's state step, and the layer and models through all
# three
# ---------------------------------------------------------------------------

def _layer(arch: str, dtype: str):
    """Reduced ``arch``'s first Mamba layer: repro's and the port's configs
    and parameters (carried across by ``params_from_numpy``)."""
    jcfg, tcfg = repro_config(arch), get_reduced_config(arch)
    jcfg = dataclasses.replace(jcfg, dtype=DTYPES[dtype][1])
    tcfg = dataclasses.replace(tcfg, dtype=DTYPES[dtype][0])
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(
        a.astype(jnp.float32)), jp)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    i = [m for m, _ in jcfg.pattern].index("mamba")
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["units"][i]["mixer"])
    return jcfg.mamba, tcfg.mamba, jl, tp["units"][0][i]["mixer"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_decode_step_plain_matches_repro(arch, dtype):
    """K8's plain step against the JAX package's ``mamba_decode`` arithmetic
    (models/mamba.py:246-257) on one layer's converted parameters, from a
    random state."""
    jm, tm, jl, tl = _layer(arch, dtype)
    h, p, n, g = tm.n_heads, tm.head_dim, tm.d_state, tm.n_groups
    a = _arrays(10, dtype, xs=((2, h, p), 1.0, 0.0, True),
                ssm=((2, h, n, p), 1.0, 0.0, False),
                dt=((2, 1, h), 1.0, 0.0, True),
                B=((2, g, n), 1.0, 0.0, True), C=((2, g, n), 1.0, 0.0, True))
    xs, dt_raw = _j(a["xs"], dtype), _j(a["dt"], dtype)
    Bm, Cm = _j(a["B"], dtype), _j(a["C"], dtype)
    dt = jax.nn.softplus(dt_raw.astype(jnp.float32) + jl["dt_bias"])[:, 0]
    A = -jnp.exp(jl["A_log"])
    dA = jnp.exp(dt * A[None, :])
    Bh, Ch = jnp.repeat(Bm, h // g, axis=1), jnp.repeat(Cm, h // g, axis=1)
    s_want = jnp.asarray(a["ssm"]) * dA[..., None, None] + jnp.einsum(
        "bhn,bh,bhp->bhnp", Bh.astype(jnp.float32), dt,
        xs.astype(jnp.float32))
    y_want = jnp.einsum("bhn,bhnp->bhp", Ch, s_want.astype(xs.dtype)) + \
        xs * jl["D"][None, :, None].astype(xs.dtype)
    s_got, y_got = K8.decode_step_plain(
        _t(a["xs"], dtype), torch.from_numpy(a["ssm"]), _t(a["dt"], dtype),
        tl["dt_bias"], tl["A_log"], _t(a["B"], dtype), _t(a["C"], dtype),
        tl["D"])
    assert s_got.dtype == torch.float32 and y_got.dtype == DTYPES[dtype][0]
    assert _rel(_np(s_got), _np(s_want)) <= 1e-6
    _forward_close(y_got, y_want, dtype)


def _repro_layer_step(jl, jm, xs, Bm, Cm, dt, state):
    """The JAX package's ``mamba_decode`` (models/mamba.py:236-257) from the
    projections to the D skip: ``(y [Bt, H, P], new state)``."""
    b, h, p = xs.shape[0], jm.n_heads, jm.head_dim
    g, n = jm.n_groups, jm.d_state
    xs, conv_x = jmamba._causal_conv(xs, jl["conv_x_w"], jl["conv_x_b"],
                                     state["conv"]["x"])
    Bm, conv_B = jmamba._causal_conv(Bm, jl["conv_B_w"], jl["conv_B_b"],
                                     state["conv"]["B"])
    Cm, conv_C = jmamba._causal_conv(Cm, jl["conv_C_w"], jl["conv_C_b"],
                                     state["conv"]["C"])
    xs = xs.reshape(b, 1, h, p)[:, 0]
    Bm, Cm = Bm.reshape(b, g, n), Cm.reshape(b, g, n)
    dt = jax.nn.softplus(dt.astype(jnp.float32) + jl["dt_bias"])[:, 0]
    dA = jnp.exp(dt * -jnp.exp(jl["A_log"])[None, :])
    Bh, Ch = jnp.repeat(Bm, h // g, axis=1), jnp.repeat(Cm, h // g, axis=1)
    s_new = state["ssm"] * dA[..., None, None] + jnp.einsum(
        "bhn,bh,bhp->bhnp", Bh.astype(jnp.float32), dt,
        xs.astype(jnp.float32))
    y = jnp.einsum("bhn,bhnp->bhp", Ch, s_new.astype(xs.dtype)) + \
        xs * jl["D"][None, :, None].astype(xs.dtype)
    return y, {"ssm": s_new, "conv": {"x": conv_x, "B": conv_B,
                                      "C": conv_C}}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_decode_layer_plain_matches_repro_over_four_tokens(arch, dtype):
    """K8's plain layer step (the three convs from their states, dt, the
    decay, the state update, the D skip) against the JAX package's
    ``mamba_decode`` arithmetic over four tokens from one random state, on
    the reduced layer's converted parameters; the port's states are written
    in place and carried from token to token, ``repro``'s returned."""
    jm, tm, jl, tl = _layer(arch, dtype)
    h, p, n, g = tm.n_heads, tm.head_dim, tm.d_state, tm.n_groups
    widths = {"x": h * p, "B": g * n, "C": g * n}
    a = _arrays(13, dtype, ssm=((2, h, n, p), 1.0, 0.0, False),
                **{k: ((2, K - 1, c), 1.0, 0.0, True)
                   for k, c in widths.items()})
    js = {"ssm": jnp.asarray(a["ssm"]),
          "conv": {k: _j(a[k], dtype) for k in widths}}
    states = [_t(a[k], dtype) for k in widths]
    ssm = torch.from_numpy(a["ssm"].copy())
    ws = [tl[f"conv_{k}_w"] for k in widths]
    bs = [tl[f"conv_{k}_b"] for k in widths]
    for i in range(4):
        t = _arrays(20 + i, dtype, xs=((2, 1, h * p), 1.0, 0.0, True),
                    B=((2, 1, g * n), 1.0, 0.0, True),
                    C=((2, 1, g * n), 1.0, 0.0, True),
                    dt=((2, 1, h), 1.0, 0.0, True))
        y_want, js = _repro_layer_step(
            jl, jm, *(_j(t[k], dtype) for k in ("xs", "B", "C", "dt")), js)
        y_got = K8.decode_layer_plain(
            *(_t(t[k], dtype) for k in ("xs", "B", "C", "dt")), ws, bs,
            states, ssm, tl["dt_bias"], tl["A_log"], tl["D"])
        assert y_got.dtype == DTYPES[dtype][0]
        _forward_close(y_got, y_want, dtype)
        assert _rel(_np(ssm), _np(js["ssm"])) <= \
            (1e-6 if dtype == "f32" else 2.0 ** -8), i
        for k, st in zip(widths, states):
            _forward_close(st, js["conv"][k], dtype)


def test_mamba_decode_writes_its_states_in_place():
    """``mamba_decode`` returns the state tensors it was given, written in
    place with what a call on their clones returns, the wrapper's plain
    version on the CPU as on the card."""
    _, tm, _, tl = _layer("mamba2-1.3b", "f32")
    rng = np.random.default_rng(14)
    h, p, n = tm.n_heads, tm.head_dim, tm.d_state
    state = {"ssm": torch.from_numpy(
        rng.normal(size=(2, h, n, p)).astype(np.float32)),
        "conv": {k: torch.from_numpy(rng.normal(
            size=(2, K - 1, c)).astype(np.float32))
            for k, c in (("x", h * p), ("B", n), ("C", n))}}
    before = torch.utils._pytree.tree_map(torch.clone, state)
    clones = torch.utils._pytree.tree_map(torch.clone, state)
    x = torch.from_numpy(rng.normal(size=(2, 1, tm.d_model)).astype(
        np.float32))
    out, new = tmamba.mamba_decode(tl, tm, x, state)
    want_out, want = tmamba.mamba_decode(tl, tm, x, clones)
    leaves = torch.utils._pytree.tree_leaves
    assert all(a is b for a, b in zip(leaves(new), leaves(state)))
    assert all(torch.equal(a, b) for a, b in zip(leaves(new), leaves(want)))
    assert not any(torch.equal(a, b)
                   for a, b in zip(leaves(new), leaves(before)))
    assert torch.equal(out, want_out)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_layer_prefill_and_decode_match_repro(arch, dtype):
    """One Mamba layer's prefill (K6 keeping its states, the SSD, K7) and
    three decode steps (K6 from the states, K8, K7 without the skip)
    against the JAX package's, on converted parameters."""
    jm, tm, jl, tl = _layer(arch, dtype)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 21, tm.d_model)).astype(np.float32)
    jo, js = jmamba.mamba_prefill(jl, jm, _j(x, dtype))
    to, ts = tmamba.mamba_prefill(tl, tm, _t(x, dtype))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "f32" else \
        dict(atol=3e-2, rtol=0)
    np.testing.assert_allclose(_np(to), _np(jo), **tol)
    for k in "xBC":         # the projections' outputs, kept
        np.testing.assert_allclose(_np(ts["conv"][k]), _np(js["conv"][k]),
                                   **tol)
    for i in range(3):
        xt = rng.normal(size=(2, 1, tm.d_model)).astype(np.float32)
        jo, js = jmamba.mamba_decode(jl, jm, _j(xt, dtype), js)
        to, ts = tmamba.mamba_decode(tl, tm, _t(xt, dtype), ts)
        np.testing.assert_allclose(_np(to), _np(jo), **tol)
        np.testing.assert_allclose(_np(ts["ssm"]), _np(js["ssm"]), **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_reduced_model_prefill_and_decode_match_repro(arch, dtype):
    """Reduced mamba2-1.3b and jamba, a prompt of 23 (not a chunk multiple)
    and four decode steps, against ``repro`` (``tests/test_torch_models.py``
    takes 40).  In bf16 jamba's MoE layers are held against ``repro``'s
    unit loop (``scan_units=False``), the port's own structure, as
    ``tests/test_torch_models.py`` holds them: under ``lax.scan`` a top-k
    choice that flips moves whole expert outputs."""
    jcfg, tcfg = repro_config(arch), get_reduced_config(arch)
    if dtype == "bf16" and jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, scan_units=False)
    jcfg = dataclasses.replace(jcfg, dtype=DTYPES[dtype][1])
    tcfg = dataclasses.replace(tcfg, dtype=DTYPES[dtype][0])
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp), tcfg, device="cpu")
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jcfg.vocab, size=(2, 23))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "f32" else \
        dict(atol=3e-2, rtol=0)
    jl, jc, jn = JT.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), None,
                            max_len=32)
    tl, tc, tn = TT.prefill(tp, tcfg, torch.from_numpy(toks), None,
                            max_len=32)
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    for i in range(4):
        tok = rng.integers(0, jcfg.vocab, size=(2,))
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                                jnp.int32(jn + i))
        tl, tc = TT.decode_step(tp, tcfg, torch.from_numpy(tok), tc, tn + i)
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)
