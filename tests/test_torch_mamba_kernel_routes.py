"""What the Mamba block's kernel wrappers decide in Python (no card, no
JAX): the route of K6 (``kernels/mamba_conv.py``) and K7
(``kernels/gated_norm.py``) from widths and pointer alignment, K6's
launch kind, K7's chunk width and widest row; and that CPU and meta inputs
still take the plain versions, bit for bit, and launch nothing."""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import gated_norm as K7
from repro_torch.kernels import mamba_conv as K6


def _at(shape, dtype, shift: int = 0):
    """A contiguous CPU tensor that starts ``shift`` elements into its
    buffer (the buffer itself on a 64-byte boundary)."""
    n = 1
    for d in shape:
        n *= d
    buf = torch.zeros(n + 64, dtype=dtype)
    lead = (-buf.data_ptr() % 64) // dtype.itemsize
    return buf[lead + shift:lead + shift + n].view(shape)


@pytest.mark.parametrize("dtype,widths,want", [
    (torch.bfloat16, (4096, 128, 128), "vector"),
    (torch.bfloat16, (200, 24, 24), "vector"),
    (torch.bfloat16, (100, 20, 20), "scalar"),
    (torch.bfloat16, (16, 16, 16), "vector"),
    (torch.bfloat16, (4096, 4, 4), "scalar"),
    (torch.float32, (200, 24, 24), "vector"),
    (torch.float32, (202, 22, 22), "scalar"),
    (torch.float32, (128, 16, 16), "vector")])
def test_conv_route_follows_the_widths(dtype, widths, want):
    """Vectors only where every segment's width is whole 16-byte vectors
    (8 bf16, 4 float32); the segments share one launch, so one ragged
    segment sends all of them element by element."""
    xs = [_at((2, 5, c), dtype) for c in widths]
    assert K6.route(widths, dtype, xs) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["x", "w", "b", "state", "g"])
@pytest.mark.parametrize("shift", [1, 2, 4])
def test_conv_route_follows_every_pointer(dtype, which, shift):
    """One tensor that does not start on a 16-byte boundary (a view
    ``shift`` elements in) sends the launch to the scalar route; 8 bf16 or
    4 float32 elements in, it is aligned again."""
    tensors = {"x": _at((2, 5, 64), dtype), "w": _at((4, 64), dtype),
               "b": _at((64,), dtype), "state": _at((2, 3, 64), dtype),
               "g": _at((2, 5, 64), dtype)}
    assert K6.route((64,), dtype, tensors.values()) == "vector"
    tensors[which] = _at(tuple(tensors[which].shape), dtype, shift)
    aligned = shift * dtype.itemsize % 16 == 0
    assert K6.route((64,), dtype, tensors.values()) == \
        ("vector" if aligned else "scalar")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("way", K6.ROUTES)
def test_conv_launch_kind(dtype, way):
    """The launchers' first argument: the dtype's code, plus 2 on the
    vector route."""
    assert K6._kind(way, dtype) == \
        {torch.float32: 0, torch.bfloat16: 1}[dtype] + 2 * (way == "vector")


@pytest.mark.parametrize("dtype,w,want", [
    (torch.bfloat16, 4096, "vector"), (torch.bfloat16, 16384, "vector"),
    (torch.bfloat16, 200, "vector"), (torch.bfloat16, 202, "scalar"),
    (torch.bfloat16, 36, "scalar"), (torch.float32, 200, "vector"),
    (torch.float32, 202, "scalar"), (torch.float32, 4096, "vector")])
def test_norm_route_follows_the_width(dtype, w, want):
    """K7's rows are whole 16-byte chunks (8 bf16, 4 float32) or go
    element by element."""
    ts = [_at((3, w), dtype) for _ in range(3)] + [_at((w,), torch.float32)]
    assert K7.route(w, dtype, ts) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", range(5))
def test_norm_route_follows_every_pointer(dtype, which):
    """y, xs, z, dout or scale one element off a 16-byte boundary: the
    scalar route; None (no skip) is left out of the check."""
    ts = [_at((3, 64), dtype) for _ in range(4)] + [_at((64,), torch.float32)]
    assert K7.route(64, dtype, ts + [None]) == "vector"
    ts[which] = _at(tuple(ts[which].shape), ts[which].dtype, 1)
    assert K7.route(64, dtype, ts) == "scalar"


@pytest.mark.parametrize("dtype,chunk,widest", [
    (torch.bfloat16, 8, 16384), (torch.float32, 4, 8192)])
def test_norm_widest_row(dtype, chunk, widest):
    """2048 chunks of 16 bytes a row: jamba-1.5-large-398b's d_inner of
    16384 in bf16."""
    assert K7.chunk(dtype) == chunk
    assert K7.max_width(dtype) == widest


def _conv_inputs(dtype, seed, widths=(24, 8, 8), bt=2, s=9):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype)
    return ([rnd(bt, s, c) for c in widths],
            [rnd(4, c, scale=0.3) for c in widths],
            [rnd(c, scale=0.1) for c in widths],
            [rnd(bt, 3, c) for c in widths],
            [rnd(bt, s, c, scale=1e-2) for c in widths])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_states", [False, True])
def test_conv_on_the_cpu_is_its_plain_version(dtype, with_states):
    """On CPU tensors the wrappers return the plain versions' bits and
    count no launch on any route."""
    xs, ws, bs, sts, gs = _conv_inputs(dtype, 3 + with_states)
    sts = sts if with_states else None
    K6.reset_counts()
    ys, new = K6.causal_conv(xs, ws, bs, sts, want_state=True)
    grads = K6.causal_conv_backward(xs, ws, bs, gs)
    for j, (x, w, b, g) in enumerate(zip(xs, ws, bs, gs)):
        y, st = K6.causal_conv_plain(x, w, b, None if sts is None
                                     else sts[j])
        assert torch.equal(ys[j], y) and torch.equal(new[j], st)
        for got, want in zip((grads[0][j], grads[1][j], grads[2][j]),
                             K6.causal_conv_backward_plain(x, w, b, g)):
            assert torch.equal(got, want)
    assert (K6.LAUNCHES, K6.BWD_LAUNCHES) == (0, 0)
    assert K6.ROUTE_LAUNCHES == {"vector": 0, "scalar": 0}


def _norm_inputs(dtype, seed, rows=5, w=48, h=3):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, dt=dtype, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * scale + shift).to(dt)
    return (rnd(rows, w), rnd(rows, w), rnd(rows, w),
            rnd(h, dt=torch.float32, scale=0.1, shift=1.0),
            rnd(w, dt=torch.float32, scale=0.1, shift=1.0),
            rnd(rows, w, scale=1e-2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("skip", [True, False])
def test_norm_on_the_cpu_is_its_plain_version(dtype, skip):
    """On CPU tensors K7's wrappers return the plain versions' bits (no
    rstd from the forward), and count no launch on any route."""
    y, xs, z, D, scale, dout = _norm_inputs(dtype, 7 + skip)
    if not skip:
        xs, D = None, None
    K7.reset_counts()
    out, rstd = K7.gated_norm(y, xs, z, D, scale)
    assert rstd is None
    assert torch.equal(out, K7.gated_norm_plain(y, xs, z, D, scale))
    if skip:
        got = K7.gated_norm_backward(dout, y, xs, z, D, scale, None)
        want = K7.gated_norm_backward_plain(dout, y, xs, z, D, scale)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (K7.LAUNCHES, K7.BWD_LAUNCHES) == (0, 0)
    assert K7.ROUTE_LAUNCHES == {"vector": 0, "scalar": 0}


def test_meta_inputs_take_the_plain_versions():
    """Meta tensors (the dry run's) come back as meta tensors of the plain
    versions' shapes and types, with no launch."""
    meta = torch.device("meta")
    xs, ws, bs, sts, gs = (
        [t.to(meta) for t in ts] for ts in _conv_inputs(torch.bfloat16, 1))
    K6.reset_counts()
    K7.reset_counts()
    ys, new = K6.causal_conv(xs, ws, bs, sts)
    dxs, dws, dbs = K6.causal_conv_backward(xs, ws, bs, gs)
    assert [t.shape for t in ys] == [x.shape for x in xs]
    assert [t.shape for t in new] == [s.shape for s in sts]
    assert [t.device.type for t in ys + dxs + dws + dbs] == ["meta"] * 12
    y, x, z, D, scale, dout = (t.to(meta) for t in
                               _norm_inputs(torch.bfloat16, 2))
    out, rstd = K7.gated_norm(y, x, z, D, scale)
    grads = K7.gated_norm_backward(dout, y, x, z, D, scale, None)
    assert out.shape == y.shape and out.device.type == "meta"
    assert rstd is None
    assert [g.shape for g in grads] == [y.shape, y.shape, z.shape, D.shape,
                                        scale.shape]
    assert K6.LAUNCHES + K6.BWD_LAUNCHES + K7.LAUNCHES + K7.BWD_LAUNCHES == 0
