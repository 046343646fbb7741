"""Kernel tests that need the card: the ARIMA bank (K1: both paths, the
segmented launch), flash attention (K2: fast and generic routes), SSD scan
(K3: chunked and generic routes, forward and backward) and GRU fit (K4)
kernels against their plain PyTorch versions on CUDA tensors (K3's
backward also bit for bit across two calls), the port's device paths on
CUDA (MoE, MLA and the prefix and codebook stubs included, against the
CPU), K2's backward against its plain version (all three routes, bit for bit
across calls and graph replays, what it refuses), K2's and K3's entries
returning gradients through their backward kernels (the train step on the card
against the CPU's is phase 18a of ``chip_smoke.py``), the train loop's
step captured in a CUDA graph against eager steps, bit for bit, and
the multi-device layer at mesh size 1 over NCCL (the train step,
a prefill through K2/K3 on local shards, ``moe_apply_ep``, the compressed
all-reduce and a checkpoint into placements; phases 22-24 at reduced
size), the serving engine's decode step captured in a CUDA graph
against the eager loop, and the AdamW update (K5) against its plain
version: bit for bit where the norm is under the clip, within stated
limits where it clips, in place and out of place, captured in a graph,
the NaN-skip, the memory of one in-place call and the inputs it refuses;
on DTensors at mesh size 1 (local shards, four kernels) bit for bit with
the same update without a mesh, and so is a mesh ``train_loop``; the mesh
step captured in a CUDA graph (``TrainProgram`` on the 1 x 1 NCCL mesh)
bit for bit eager mesh steps, and refused on a gloo group; the Mamba
block's kernels (K6 conv, K7 gated norm, forward and backward, K8 decode
step) against their plain versions, bitwise across calls, their entries'
gradients, their launches in a reduced train loop and decode, and what
they refuse; and so the unit's K9 (residual add + RMSNorm) and K10
(SwiGLU gate), forward and backward, bitwise across calls and graph
replays.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor ``repro``: the machine with the card has
only the port's dependencies.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.core.arima import ARIMA, pack_bank
from repro_torch.core.kmeans import kmeans
from repro_torch.core.rnn_predictor import GRUPredictor, init_params
from repro_torch.kernels import adamw as K5
from repro_torch.kernels import arima_bank as K
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import gated_norm as K7
from repro_torch.kernels import gru_fit as K4
from repro_torch.kernels import mamba_conv as K6
from repro_torch.kernels import mamba_decode as K8
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as K3
from repro_torch.models import transformer as TT
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.mamba import MambaConfig

pytestmark = pytest.mark.cuda

# kernel vs plain on the same card: the kernel is built without FMA
# contraction and sums in the plain version's order, so the two should
# agree bit for bit; 1e-3 leaves room for a library function (powf) that
# rounds differently, amplified by the Adam trajectory
RTOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(seed, rows, n):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.normal(3600.0, 400.0, size=(rows, n)).astype(np.float32))


@pytest.mark.parametrize("order,n", [((2, 1, 1), 4), ((2, 1, 1), 16),
                                     ((2, 1, 1), 60), ((1, 2, 0), 32),
                                     ((4, 2, 4), 24)])
def test_kernel_matches_plain(cuda, order, n):
    y = _rows(n, 300, n).to(cuda)
    got = K.arima_bank(y, order, 200, 0.05)
    want = K.arima_fit_plain(y, order, 200, 0.05)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    torch.testing.assert_close(got[ok], want[ok], rtol=RTOL, atol=0.0)


def test_kernel_rows_independent_of_launch(cuda):
    y = _rows(1, 200, 16).to(cuda)
    full = K.arima_bank(y, (2, 1, 1), 200, 0.05)
    rev = K.arima_bank(y.flip(0).contiguous(), (2, 1, 1), 200, 0.05).flip(0)
    alone = torch.cat([K.arima_bank(y[i:i + 1].contiguous(), (2, 1, 1), 200,
                                    0.05) for i in range(0, 200, 23)])
    assert torch.equal(full.view(torch.int32), rev.view(torch.int32))
    assert torch.equal(full[::23].view(torch.int32), alone.view(torch.int32))


@pytest.mark.parametrize("n", [4, 8, 16, 32, 60])
def test_register_path_equals_plain_bitwise(cuda, n):
    assert K.route((2, 1, 1), n) == "register"
    y = _rows(100 + n, 300, n).to(cuda)
    got = K.arima_bank(y, (2, 1, 1), 200, 0.05)
    want = K.arima_fit_plain(y, (2, 1, 1), 200, 0.05)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _launch(y, out, table, order, steps=200):
    """The library's launcher on a raw table of (row offset, rows, n,
    path); returns its CUDA error code."""
    flat = [v for entry in table for v in entry]
    cells = (ctypes.c_int * len(flat))(*flat)
    err = K._load().arima_bank_launch(
        y.data_ptr(), out.data_ptr(), cells, len(table), *order, steps,
        0.05, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return err


@pytest.mark.parametrize("n", [8, 60])
def test_register_and_generic_paths_agree_bitwise(cuda, n):
    y = _rows(7 + n, 96, n).to(cuda)
    reg, gen = torch.empty(96, device=cuda), torch.empty(96, device=cuda)
    assert _launch(y, reg, [(0, 96, n, 1)], (2, 1, 1)) == 0
    assert _launch(y, gen, [(0, 96, n, 0)], (2, 1, 1)) == 0
    assert torch.equal(reg.view(torch.int32), gen.view(torch.int32))


@pytest.mark.parametrize("table,order", [
    ([(0, 40, 8, 1), (40, 32, 4, 1)], (2, 1, 1)),   # a warp mixes two n
    ([(0, 32, 8, 1), (64, 32, 4, 1)], (2, 1, 1)),   # a gap
    ([(0, 32, 24, 1)], (2, 1, 1)),                  # no register path
    ([(0, 32, 8, 1)], (1, 2, 0)),                   # no register path
])
def test_launcher_refuses_a_table_it_does_not_take(cuda, table, order):
    y = torch.zeros(sum(r * n for _, r, n, _ in table), device=cuda)
    out = torch.full((sum(r for _, r, _, _ in table),), 7.0, device=cuda)
    assert _launch(y, out, table, order) != 0
    assert bool((out == 7.0).all())


def test_launcher_takes_the_register_path_at_exactly_register_n(cuda):
    # the build passes REGISTER_N to the source: the launcher's register
    # set is the wrapper's
    taken = []
    for n in range(3, K.MAX_N + 1):
        y = _rows(n, 32, n).to(cuda)
        out = torch.empty(32, device=cuda)
        if _launch(y, out, [(0, 32, n, 1)], (2, 1, 1), steps=1) == 0:
            taken.append(n)
    assert tuple(taken) == K.REGISTER_N


def test_register_path_division_and_square_root_are_ieee(cuda):
    # 2^30 random operand pairs inside the division's range, every float
    # inside the square root's
    assert K.refined_mismatches(1 << 30, 1, cuda) == (0, 0)


def test_segment_launch_equals_per_bucket_launches(cuda):
    rng = np.random.default_rng(6)
    buckets = {n: [rng.normal(3600.0, 400.0, size=n).astype(np.float32)
                   for _ in range(k)]
               for n, k in ((4, 40), (8, 7), (16, 64), (32, 33), (60, 90))}
    flat, table = pack_bank(buckets)
    K.reset_counts()
    got = K.arima_bank_segments(torch.from_numpy(flat).to(cuda), table,
                                (2, 1, 1), 200, 0.05)
    assert (K.LAUNCHES, K.ROWS) == (1, sum(r for _, r, _ in table))
    for row0, _, n in table:
        y = torch.from_numpy(np.stack(buckets[n])).to(cuda)
        own = K.arima_bank(y, (2, 1, 1), 200, 0.05)
        torch.cuda.synchronize()
        assert torch.equal(got[row0:row0 + len(y)].view(torch.int32),
                           own.view(torch.int32))


def test_batched_forecast_is_one_launch(cuda):
    rng = np.random.default_rng(8)
    series = [rng.normal(3600.0, 400.0, size=k).astype(np.float32)
              for k in (3, 4, 6, 9, 17, 33, 60, 61, 120) * 20]
    model = ARIMA(device=cuda)
    K.reset_counts()
    batched = model.batched_forecast(series)
    assert K.LAUNCHES == 1
    assert batched.tolist() == [model.forecast_next(s) for s in series]


@pytest.mark.parametrize("n", [4, 60])
def test_one_row_call_equals_its_row_in_a_300_row_launch(cuda, n):
    y = _rows(200 + n, 300, n).to(cuda)
    full = K.arima_bank(y, (2, 1, 1), 200, 0.05)
    for i in (0, 31, 32, 150, 299):
        one = K.arima_bank(y[i:i + 1].contiguous(), (2, 1, 1), 200, 0.05)
        torch.cuda.synchronize()
        assert torch.equal(one.view(torch.int32),
                           full[i:i + 1].view(torch.int32))


def test_kernel_counts_launches_and_rows(cuda):
    K.reset_counts()
    K.arima_bank(_rows(2, 70, 8).to(cuda), (2, 1, 1), 20, 0.05)
    K.arima_bank(_rows(3, 5, 8).to(cuda), (2, 1, 1), 20, 0.05)
    assert (K.LAUNCHES, K.ROWS) == (2, 75)


def test_online_equals_batched_on_cuda(cuda):
    rng = np.random.default_rng(4)
    series = [rng.normal(3600.0, 400.0, size=k).astype(np.float32)
              for k in (0, 2, 4, 9, 16, 16, 30, 60, 61, 5)] + \
        [rng.normal(3600.0, 400.0, size=16).astype(np.float32)
         for _ in range(40)]
    model = ARIMA(device=cuda)
    batched = model.batched_forecast(series)
    assert batched.tolist() == [model.forecast_next(s) for s in series]


def test_kmeans_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, 4, 3000), rng.integers(0, 6, 3000),
                  rng.integers(0, 6, 3000) * 5.0 / 6.0], axis=1)
    cg, ag, _ = kmeans(x, 4, device=cuda)
    cc, ac, _ = kmeans(x, 4, device="cpu")
    assert np.array_equal(ag, ac)
    np.testing.assert_allclose(cg, cc, rtol=1e-5, atol=1e-5)


# K2: the shapes of the JAX package's ATTN_SWEEP (tests/test_kernels.py),
# then ragged lengths and head dim 64.  Tolerances as there: 2e-5 float32,
# 2e-2 bfloat16.
ATTN_SHAPES = [
    # b, s, hq, hkv, d, window, dtype, tol
    (1, 256, 2, 2, 128, None, torch.float32, 2e-5),
    (2, 256, 4, 2, 128, None, torch.float32, 2e-5),
    (1, 512, 4, 1, 128, None, torch.float32, 2e-5),
    (1, 256, 2, 2, 128, 128, torch.float32, 2e-5),
    (1, 512, 8, 2, 128, 256, torch.float32, 2e-5),
    (1, 256, 2, 2, 128, None, torch.bfloat16, 2e-2),
    (2, 384, 6, 2, 128, None, torch.float32, 2e-5),
    (1, 1, 4, 1, 64, None, torch.float32, 2e-5),
    (1, 33, 8, 2, 64, 16, torch.float32, 2e-5),
    (2, 300, 8, 1, 64, 100, torch.bfloat16, 2e-2),
    # head dim 160 (stablelm-12b): S=1, a ragged S with a window, float32
    (1, 1, 4, 1, 160, None, torch.bfloat16, 2e-2),
    (2, 77, 8, 2, 160, 32, torch.bfloat16, 2e-2),
    (1, 200, 4, 2, 160, None, torch.float32, 2e-5),
    # a group of 9 query heads (starcoder2-7b) does not divide a 128-row tile
    (1, 130, 9, 1, 128, None, torch.bfloat16, 2e-2),
    # the serving prefills: stablelm-12b, gemma3-27b's local-window layers
    (1, 2000, 32, 8, 160, None, torch.bfloat16, 2e-2),
    (1, 2000, 32, 16, 128, 1024, torch.bfloat16, 2e-2),
    # head dim 256 (paligemma-3b): S=1, a ragged S, a window, a ragged S
    # with a window, its full-width attention (8/1 heads at S=2048) in both
    # types
    (1, 1, 4, 1, 256, None, torch.bfloat16, 2e-2),
    (2, 33, 8, 2, 256, None, torch.bfloat16, 2e-2),
    (1, 256, 4, 2, 256, 128, torch.bfloat16, 2e-2),
    (1, 300, 8, 2, 256, None, torch.bfloat16, 2e-2),
    (1, 65, 4, 1, 256, 16, torch.float32, 2e-5),
    (1, 2048, 8, 1, 256, None, torch.bfloat16, 2e-2),
    (1, 2048, 8, 1, 256, None, torch.float32, 2e-5),
    # groups of 7 query heads (arctic-480b's 56/8), ragged and at its
    # prefill; musicgen-large's 32/32 heads of 64 and paligemma-3b's 8/1 of
    # 256 at their served lengths (2000 tokens after 64 and 256 prefix
    # positions)
    (1, 77, 14, 2, 128, None, torch.bfloat16, 2e-2),
    (1, 2000, 56, 8, 128, None, torch.bfloat16, 2e-2),
    (1, 2064, 32, 32, 64, None, torch.bfloat16, 2e-2),
    (1, 2256, 8, 1, 256, None, torch.bfloat16, 2e-2),
]


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("b,s,hq,hkv,d,window,dtype,tol", ATTN_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda, b, s, hq, hkv, d, window,
                                              dtype, tol):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = _randn(gen, (b, s, hq, d), dtype, cuda)
    k = _randn(gen, (b, s, hkv, d), dtype, cuda)
    v = _randn(gen, (b, s, hkv, d), dtype, cuda)
    K2.reset_counts()
    got = K2.flash_attention(q, k, v, window=window)
    want = K2.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert K2.LAUNCHES == K2.ROUTE_LAUNCHES[K2.route(d, dtype)] == 1
    assert K2.route(d, dtype) != "generic" and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_kernel_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros((1, 16, 2, 257), device=cuda)
    K2.reset_counts()
    with pytest.raises(ValueError, match="head dim"):
        K2.flash_attention(q, q, q)
    assert K2.LAUNCHES == 0
    q = torch.zeros((1, 16, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="causal"):
        K2.flash_attention(q, q, q, causal=False)


# ---------------------------------------------------------------------------
# K2's backward: against its plain version, from the forward kernel's output
# and log-sum-exp
# ---------------------------------------------------------------------------

# b, s, hq, hkv, d, window, dtype: every route at tails that are not whole
# tiles of keys or folded rows, with and without a window, at groups of 1,
# 7 and 8 query heads; S = 1; yi-6b's heads at a ragged length; the wgmma
# route's head dims 64 and 128, the mma route's 160 and 256; the reduced
# configs' head dims 8-20 in both types
BWD_ATTN_SHAPES = [
    (1, 77, 8, 8, 128, None, torch.bfloat16),
    (2, 100, 14, 2, 128, 32, torch.bfloat16),
    (1, 130, 8, 1, 128, None, torch.bfloat16),
    (1, 1, 4, 1, 64, None, torch.bfloat16),
    (1, 300, 32, 4, 128, None, torch.bfloat16),
    (1, 200, 16, 8, 128, 100, torch.bfloat16),
    (2, 65, 4, 4, 64, None, torch.bfloat16),
    (1, 150, 16, 2, 64, 7, torch.bfloat16),
    (1, 77, 8, 2, 160, 16, torch.bfloat16),
    (1, 129, 4, 1, 160, None, torch.bfloat16),
    (1, 77, 8, 8, 128, None, torch.float32),
    (2, 100, 14, 2, 128, 32, torch.float32),
    (1, 130, 8, 1, 64, None, torch.float32),
    (1, 1, 4, 1, 160, None, torch.float32),
    (1, 65, 8, 1, 256, None, torch.bfloat16),
    (1, 40, 4, 2, 256, 9, torch.float32),
    (2, 100, 4, 2, 16, None, torch.bfloat16),
    (1, 70, 6, 2, 12, 5, torch.float32),
    (1, 90, 7, 1, 20, None, torch.float32),
    (1, 33, 8, 1, 8, None, torch.bfloat16),
]
# relative L2 of each gradient: float32 sums in other orders; bfloat16
# rounds P and dS to bf16 for their products where the plain version keeps
# them float32, and rounds the gradients.  A reference whose RMS is under
# 1e-3 (dq and dk at S = 1 are zero but for rounding: each row's softmax is
# the constant 1) is held by the error's RMS, the inputs being of unit
# scale.
K2_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _grad_err(got, want) -> float:
    g, w = got.double(), want.double()
    den = w.norm()
    if den <= 1e-3 * w.numel() ** 0.5:
        den = w.numel() ** 0.5
    return float((g - w).norm() / den)


def _attn_bwd_inputs(cuda, b, s, hq, hkv, d, window, dtype, seed):
    """q, k, v, the forward kernel's output and log-sum-exp, and dO."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = _randn(gen, (b, s, hq, d), dtype, cuda)
    k = _randn(gen, (b, s, hkv, d), dtype, cuda)
    v = _randn(gen, (b, s, hkv, d), dtype, cuda)
    do = _randn(gen, (b, s, hq, d), dtype, cuda)
    o, lse = K2.flash_attention(q, k, v, window=window, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("b,s,hq,hkv,d,window,dtype", BWD_ATTN_SHAPES)
def test_flash_backward_kernel_matches_plain(cuda, b, s, hq, hkv, d, window,
                                             dtype):
    args = _attn_bwd_inputs(cuda, b, s, hq, hkv, d, window, dtype, s + hq)
    path = K2.backward_route(d, dtype)
    K2.reset_counts()
    got = K2.flash_attention_backward(*args, window=window)
    want = K2.flash_attention_backward_plain(*args, window=window)
    torch.cuda.synchronize()
    assert K2.BWD_LAUNCHES == K2.BWD_ROUTE_LAUNCHES[path] == 1
    assert K2.LAUNCHES == 0
    for name, a, w, like in zip(("dq", "dk", "dv"), got, want, args):
        assert a.dtype == like.dtype and a.shape == like.shape, name
        assert bool(torch.isfinite(a).all()), name
        err = _grad_err(a, w)
        assert err <= K2_BWD_TOL[dtype], (name, err)


@pytest.mark.parametrize("b,s,hq,hkv,d,window,dtype", [
    (1, 77, 8, 8, 128, None, torch.bfloat16),
    (2, 100, 14, 2, 128, 32, torch.bfloat16),
    (1, 130, 8, 1, 256, None, torch.bfloat16),
    (1, 65, 6, 2, 12, 5, torch.float32),
    (1, 200, 4, 2, 160, None, torch.float32),
    (2, 2048, 16, 2, 128, None, torch.bfloat16),
    (1, 2048, 16, 8, 128, 1024, torch.bfloat16),
    (1, 2048, 8, 2, 160, None, torch.bfloat16)])
def test_flash_forward_lse_matches_plain_and_leaves_the_output(
        cuda, b, s, hq, hkv, d, window, dtype):
    """Every route's log-sum-exp against the plain version's, and the
    output bit for bit the same with and without it."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = _randn(gen, (b, s, hq, d), dtype, cuda)
    k = _randn(gen, (b, s, hkv, d), dtype, cuda)
    v = _randn(gen, (b, s, hkv, d), dtype, cuda)
    out, lse = K2.flash_attention(q, k, v, window=window, return_lse=True)
    alone = K2.flash_attention(q, k, v, window=window)
    _, want = K2.flash_attention_plain(q, k, v, window=window,
                                       return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, alone)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, s)
    torch.testing.assert_close(lse, want, atol=2e-4, rtol=2e-5)


# b, s, hq, hkv, d, window: the wgmma route at three batches, S of one
# position, of tails past whole tiles of 64 and 128 (33, 65, 2000) and of
# whole tiles (2048), groups of 1, 2, 7 and 8 query heads (7: row tiles
# that start mid-group), and a window of 1024 that starts the walks
# mid-sequence
WGMMA_BWD_SHAPES = [
    (3, 1, 8, 1, 128, None),
    (3, 33, 7, 1, 128, None),
    (3, 65, 4, 2, 64, None),
    (3, 2000, 8, 8, 64, None),
    (3, 2048, 14, 2, 128, None),
    (3, 2048, 16, 2, 128, 1024),
    (3, 2000, 8, 4, 128, 1024),
]


@pytest.mark.parametrize("b,s,hq,hkv,d,window", WGMMA_BWD_SHAPES)
def test_flash_backward_wgmma_route_matches_plain(cuda, b, s, hq, hkv, d,
                                                  window):
    """The wgmma route against the plain backward (rel L2 K2_BWD_TOL),
    launched once a call on exactly that route, and bitwise across two
    calls."""
    assert K2.backward_route(d, torch.bfloat16) == "wgmma"
    args = _attn_bwd_inputs(cuda, b, s, hq, hkv, d, window, torch.bfloat16,
                            s + hq + d)
    K2.reset_counts()
    got = K2.flash_attention_backward(*args, window=window)
    again = K2.flash_attention_backward(*args, window=window)
    want = K2.flash_attention_backward_plain(*args, window=window)
    torch.cuda.synchronize()
    assert K2.BWD_LAUNCHES == K2.BWD_ROUTE_LAUNCHES["wgmma"] == 2
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, a2), name
        err = _grad_err(a, w)
        assert err <= K2_BWD_TOL[torch.bfloat16], (name, err)


def test_flash_backward_launcher_refuses_routes_and_pointers(cuda):
    """The launcher takes exactly the route it is given: wgmma only for
    bfloat16 at its head dims, mma only at its own, no unknown code; and
    refuses a pointer off 16 bytes on the tensor-core routes (the wrapper
    raises before it gets there)."""
    b, s, hq, hkv, d = 1, 64, 4, 2, 128
    args = _attn_bwd_inputs(cuda, b, s, hq, hkv, d, None, torch.bfloat16, 9)
    q, k, v, o, lse, do = args
    delta = torch.empty_like(lse)
    outs = [torch.empty_like(t) for t in (q, k, v)]
    lib = K2._load_bwd()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(ptrs, dd, dtype_code, route):
        return lib.flash_attention_bwd_launch(
            *ptrs, lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outs), b, s, hq, hkv, dd, 0, 0.1,
            dtype_code, route, stream)

    ptrs = [t.data_ptr() for t in (q, k, v, o, do)]
    wg = K2.BWD_ROUTES.index("wgmma")
    mma = K2.BWD_ROUTES.index("mma")
    assert launch(ptrs, 128, 1, wg) == 0
    assert launch(ptrs, 96, 1, wg) == -1          # not a wgmma head dim
    assert launch(ptrs, 160, 1, wg) == -1         # mma's head dim
    assert launch(ptrs, 128, 0, wg) == -1         # float32
    assert launch(ptrs, 128, 1, mma) == -1        # wgmma's head dim
    assert launch(ptrs, 128, 1, 3) == -1          # no such route
    off = [p + 2 for p in ptrs]                   # one bf16 element in
    assert launch(off, 128, 1, wg) == -3
    torch.cuda.synchronize()
    flat = torch.zeros(q.numel() + 8, dtype=q.dtype, device=cuda)
    odd = flat[1:1 + q.numel()].view(q.shape)
    odd.copy_(q)
    K2.reset_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        K2.flash_attention_backward(odd, k, v, o, lse, do)
    assert K2.BWD_LAUNCHES == 0


@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16),
                                     (64, torch.bfloat16),
                                     (160, torch.bfloat16),
                                     (16, torch.float32)])
def test_flash_backward_two_calls_and_graph_replays_bitwise(cuda, d, dtype):
    """Two calls, and two replays of a call captured in a CUDA graph, give
    the same bits: every sum runs in a fixed order, no atomics."""
    args = _attn_bwd_inputs(cuda, 2, 150, 14, 2, d, None, dtype, 3)
    one = K2.flash_attention_backward(*args)
    two = K2.flash_attention_backward(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        K2.flash_attention_backward(*args)          # warm-up on the stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = K2.flash_attention_backward(*args)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in captured])
    for got in (two, *replays):
        for a, b in zip(one, got):
            assert torch.equal(a, b)


def test_flash_backward_raises_on_what_it_does_not_take(cuda):
    args = list(_attn_bwd_inputs(cuda, 1, 64, 4, 2, 64, None, torch.bfloat16,
                                 0))
    K2.reset_counts()
    with pytest.raises(ValueError, match="causal"):
        K2.flash_attention_backward(*args, causal=False)
    short_v = args[2][..., :32].contiguous()
    with pytest.raises(ValueError, match="Dk == Dv"):
        K2.flash_attention_backward(args[0], args[1], short_v, *args[3:])
    with pytest.raises(TypeError, match="one type"):
        K2.flash_attention_backward(*args[:5], args[5].float())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K2.flash_attention_backward(*(a.half() for a in args[:4]), args[4],
                                    args[5].half())
    with pytest.raises(ValueError, match="lse"):
        K2.flash_attention_backward(*args[:4], args[4].double(), args[5])
    with pytest.raises(ValueError, match="contiguous"):
        K2.flash_attention_backward(*args[:5],
                                    args[5].transpose(1, 2).contiguous()
                                    .transpose(1, 2))
    with pytest.raises(ValueError, match="window"):
        K2.flash_attention_backward(*args, window=0)
    wide = torch.zeros((1, 8, 2, 264), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        K2.flash_attention_backward(wide, wide, wide, wide,
                                    torch.zeros((1, 2, 8), device=cuda), wide)
    assert K2.BWD_LAUNCHES == 0


# K3: the shapes of the JAX package's SSD_SWEEP, then a ragged length and
# state/head dims 64.  Tolerances as there: 1e-3 float32, 5e-2 bfloat16.
SSD_SHAPES = [
    # bt, s, h, p, g, n, dtype, tol
    (1, 256, 2, 128, 1, 128, torch.float32, 1e-3),
    (2, 256, 4, 128, 2, 128, torch.float32, 1e-3),
    (1, 512, 2, 128, 1, 128, torch.float32, 1e-3),
    (1, 256, 2, 128, 1, 128, torch.bfloat16, 5e-2),
    (2, 100, 4, 64, 2, 64, torch.float32, 1e-3),
    # two sequences, two groups, on the tensor cores; P = 128 with N = 64;
    # N = P = 64
    (2, 300, 4, 64, 2, 128, torch.bfloat16, 5e-2),
    (2, 256, 4, 128, 2, 64, torch.bfloat16, 5e-2),
    (1, 200, 4, 64, 1, 64, torch.bfloat16, 5e-2),
]


def _ssd_inputs(gen, bt, s, h, p, g, n, dtype, device):
    x = _randn(gen, (bt, s, h, p), dtype, device)
    dt = torch.nn.functional.softplus(
        torch.randn((bt, s, h), generator=gen, device=device))
    A = -torch.exp(torch.randn((h,), generator=gen, device=device) * 0.5)
    B = _randn(gen, (bt, s, g, n), dtype, device)
    C = _randn(gen, (bt, s, g, n), dtype, device)
    return x, dt, A, B, C


@pytest.mark.parametrize("bt,s,h,p,g,n,dtype,tol", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda, bt, s, h, p, g, n, dtype, tol):
    gen = torch.Generator(device=cuda).manual_seed(s + h)
    inputs = _ssd_inputs(gen, bt, s, h, p, g, n, dtype, cuda)
    K3.reset_counts()
    y, state = K3.ssd_scan(*inputs)
    wy, ws = K3.ssd_scan_plain(*inputs)
    torch.cuda.synchronize()
    assert K3.LAUNCHES == 1 and y.dtype == dtype
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, ws, atol=tol, rtol=tol)


def _pad(t, n, dim=1):
    """``t`` with ``n`` zeros appended along ``dim``."""
    shape = list(t.shape)
    shape[dim] = n
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("s", [1, 63, 65, 2000])
def test_ssd_scan_kernel_ragged_and_dt0_padded(cuda, s, dtype, tol):
    """Any S, and the model's padding to its 256 chunk (dt = 0, x = B = C
    = 0 past S) leaves y[:S] and the final state as they were."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    x, dt, A, B, C = _ssd_inputs(gen, 1, s, 4, 64, 1, 128, dtype, cuda)
    wy, ws = K3.ssd_scan_plain(x, dt, A, B, C)
    y, state = K3.ssd_scan(x, dt, A, B, C)
    pad = (-s) % 256
    py, pstate = K3.ssd_scan(_pad(x, pad), _pad(dt, pad), A, _pad(B, pad),
                             _pad(C, pad))
    torch.cuda.synchronize()
    for got_y, got_state in ((y, state), (py[:, :s], pstate)):
        torch.testing.assert_close(got_y.float(), wy.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(got_state, ws, atol=tol, rtol=tol)


def test_ssd_scan_kernel_state_carries_across_a_split(cuda):
    """The final state of the whole sequence is the first part's state
    decayed through the second part plus the second part's own state (the
    recurrence is linear); the split is not on a chunk boundary."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    x, dt, A, B, C = _ssd_inputs(gen, 2, 300, 4, 64, 2, 64, torch.float32,
                                 cuda)
    cut = 130
    _, whole = K3.ssd_scan(x, dt, A, B, C)
    _, first = K3.ssd_scan(*(t[:, :cut].contiguous() for t in (x, dt)), A,
                           *(t[:, :cut].contiguous() for t in (B, C)))
    _, second = K3.ssd_scan(*(t[:, cut:].contiguous() for t in (x, dt)), A,
                            *(t[:, cut:].contiguous() for t in (B, C)))
    carry = torch.exp(dt[:, cut:].sum(dim=1) * A)          # [Bt, H]
    torch.cuda.synchronize()
    torch.testing.assert_close(whole, carry[..., None, None] * first + second,
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_launch_refuses_scratch_of_another_chunk_count(cuda, dtype):
    """The library states its inner chunk, and its launcher refuses a
    chunk count other than ceil(S / chunk) before it writes a byte."""
    s, h, n, p = 300, 4, 64, 64
    chunk = K3.inner_chunk(dtype)
    assert chunk in (64, 128) and K3.n_chunks(s, dtype) == -(-s // chunk)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, dt, A, B, C = _ssd_inputs(gen, 1, s, h, p, 1, n, dtype, cuda)
    y = torch.zeros_like(x)
    state = torch.zeros((1, h, n, p), device=cuda)
    nc = K3.n_chunks(s, dtype) - 1                    # one chunk short
    states = torch.zeros((1, nc, h, n, p), device=cuda)
    decay = torch.zeros((1, nc, h), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    err = K3._load().ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), states.data_ptr(), decay.data_ptr(),
        1, s, h, 1, n, p, {torch.float32: 0, torch.bfloat16: 1}[dtype], nc,
        K3.ROUTES.index("chunked"), stream)
    torch.cuda.synchronize()
    assert err == -1
    assert not y.float().abs().any() and not states.abs().any()


def _small_models():
    dense = TT.ModelConfig(
        name="dense-d64", d_model=256, n_layers=2, vocab=512,
        pattern=(("attn", "dense"),),
        attn=AttentionConfig(d_model=256, n_heads=4, n_kv_heads=2,
                             head_dim=64, window=48),
        d_ff=512, dtype=torch.float32)
    ssm = TT.ModelConfig(
        name="ssm-n64", d_model=128, n_layers=2, vocab=512,
        pattern=(("mamba", "none"),),
        mamba=MambaConfig(d_model=128, d_state=64, head_dim=64,
                          chunk_size=32), dtype=torch.float32)
    return [dense, ssm]


@pytest.mark.parametrize("cfg", _small_models(), ids=lambda c: c.name)
def test_prefill_on_cuda_goes_through_the_kernels(cuda, cfg):
    """A small model's prefill on the card (K2/K3) against the same
    parameters' prefill on the CPU (the plain chunked paths)."""
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    on_card = TT._to(params, cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 70),
                           generator=torch.Generator().manual_seed(1))
    K2.reset_counts()
    K3.reset_counts()
    want, _, _ = TT.prefill(params, cfg, tokens, max_len=80)
    assert (K2.LAUNCHES, K3.LAUNCHES) == (0, 0)
    got, caches, _ = TT.prefill(on_card, cfg, tokens.to(cuda), max_len=80)
    torch.cuda.synchronize()
    mixer = cfg.pattern[0][0]
    assert (K2.LAUNCHES, K3.LAUNCHES) == \
        ((cfg.n_layers, 0) if mixer == "attn" else (0, cfg.n_layers))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    logits, _ = TT.decode_step(on_card, cfg, got.argmax(-1), caches, 70)
    assert torch.isfinite(logits).all()


# K2's generic route: head dims outside HEAD_DIMS (the reduced configs'
# 8-20, paligemma-3b's 256), both types, windows, GQA and ragged lengths.
# Tolerances as for the fast routes.
GENERIC_ATTN_SHAPES = [
    # b, s, hq, hkv, d, window, dtype, tol
    (1, 200, 4, 2, 8, None, torch.float32, 2e-5),
    (2, 77, 6, 2, 12, 32, torch.bfloat16, 2e-2),
    (1, 130, 4, 2, 16, None, torch.bfloat16, 2e-2),
    (1, 256, 4, 4, 20, 64, torch.float32, 2e-5),
    (2, 100, 9, 3, 20, None, torch.bfloat16, 2e-2),
    (1, 1, 2, 1, 12, None, torch.float32, 2e-5),
    # the widest padding (DP = 256) at head dims the fast routes leave out
    (1, 300, 8, 2, 255, None, torch.bfloat16, 2e-2),
    (1, 65, 4, 1, 200, 16, torch.float32, 2e-5),
    (1, 96, 2, 2, 1, None, torch.float32, 2e-5),
    # chip_smoke.py phase 16: the reduced configs' attention at S=2048
    (1, 2048, 4, 2, 16, None, torch.bfloat16, 2e-2),
    (1, 2048, 6, 2, 12, None, torch.bfloat16, 2e-2),
    (1, 2048, 4, 2, 20, None, torch.float32, 2e-5),
    (1, 2048, 4, 2, 16, 32, torch.bfloat16, 2e-2),
    (1, 512, 4, 1, 8, None, torch.float32, 2e-5),
]


@pytest.mark.parametrize("b,s,hq,hkv,d,window,dtype,tol", GENERIC_ATTN_SHAPES)
def test_flash_attention_generic_route_matches_plain(cuda, b, s, hq, hkv, d,
                                                     window, dtype, tol):
    assert K2.route(d, dtype) == "generic"
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = _randn(gen, (b, s, hq, d), dtype, cuda)
    k = _randn(gen, (b, s, hkv, d), dtype, cuda)
    v = _randn(gen, (b, s, hkv, d), dtype, cuda)
    K2.reset_counts()
    got = K2.flash_attention(q, k, v, window=window)
    want = K2.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert K2.ROUTE_LAUNCHES["generic"] == K2.LAUNCHES == 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# K3's generic route: N, P outside the chunked route's (the reduced
# mamba2's N = P = 16, and mixed (N, P)), both types, ragged lengths.
GENERIC_SSD_SHAPES = [
    # bt, s, h, p, g, n, dtype, tol
    (1, 256, 4, 16, 1, 16, torch.float32, 1e-3),
    (2, 300, 8, 16, 2, 16, torch.bfloat16, 5e-2),
    (1, 200, 4, 64, 1, 16, torch.float32, 1e-3),
    (1, 100, 2, 16, 1, 64, torch.bfloat16, 5e-2),
    (1, 1, 2, 16, 1, 16, torch.float32, 1e-3),
    (1, 64, 2, 32, 1, 256, torch.float32, 1e-3),
    # chip_smoke.py phase 16: mamba2-1.3b-reduced's scan at S=2048, and
    # (N, P) = (16, 64)
    (1, 2048, 8, 16, 1, 16, torch.bfloat16, 5e-2),
    (1, 2048, 8, 16, 1, 16, torch.float32, 1e-3),
    (1, 2048, 8, 64, 1, 16, torch.bfloat16, 5e-2),
]


@pytest.mark.parametrize("bt,s,h,p,g,n,dtype,tol", GENERIC_SSD_SHAPES)
def test_ssd_scan_generic_route_matches_plain(cuda, bt, s, h, p, g, n, dtype,
                                              tol):
    assert K3.route(n, p, dtype) == "generic"
    gen = torch.Generator(device=cuda).manual_seed(s + n + p)
    inputs = _ssd_inputs(gen, bt, s, h, p, g, n, dtype, cuda)
    K3.reset_counts()
    y, state = K3.ssd_scan(*inputs)
    wy, ws = K3.ssd_scan_plain(*inputs)
    torch.cuda.synchronize()
    assert K3.ROUTE_LAUNCHES["generic"] == K3.LAUNCHES == 1
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, ws, atol=tol, rtol=tol)


# K3's backward, given the forward's incoming chunk states, against its
# plain version (the same chunked decomposition in eager float32, its
# states recomputed) on the forward's shapes, both routes, 12 and 10 heads
# a group (not a multiple of the gradient pass's slab of 8; the first over
# S shorter than one chunk), and mamba2-1.3b's training shape (4 x 2048
# tokens, 64 heads of 64, N = 128, bf16).
# Relative L2 per gradient: float32 1e-4 (float32 sums in other orders;
# the generic route runs the exact recurrence, not the chunked algebra);
# bfloat16 5e-4 (the same float32 algebra on the widened inputs, dx, dB
# and dC rounded to bfloat16 on both sides; the kernel reads <= 1.3e-4,
# and a build whose float32 factors lose their lo bf16 terms 2.5e-3 on
# dx, dB and dC: scripts/k3_bwd_lo_control.py).
BWD_SSD_SHAPES = [s[:7] for s in SSD_SHAPES + GENERIC_SSD_SHAPES] + [
    (2, 40, 12, 64, 1, 64, torch.bfloat16),
    (1, 300, 20, 128, 2, 128, torch.float32),
    (1, 200, 20, 64, 2, 128, torch.bfloat16),
    (4, 2048, 64, 64, 1, 128, torch.bfloat16)]
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-4}


def _bwd_inputs(cuda, bt, s, h, p, g, n, dtype, seed):
    """x, dt, A, B, C, dy, dfinal and the incoming chunk states K3's
    forward keeps for them (None on the generic route)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x, dt, A, B, C = _ssd_inputs(gen, bt, s, h, p, g, n, dtype, cuda)
    dy = _randn(gen, (bt, s, h, p), dtype, cuda)
    dfinal = torch.randn((bt, h, n, p), generator=gen, device=cuda)
    _, _, states = K3.ssd_scan(x, dt, A, B, C, keep_states=True)
    return x, dt, A, B, C, dy, dfinal, states


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


@pytest.mark.parametrize("bt,s,h,p,g,n,dtype", BWD_SSD_SHAPES)
def test_ssd_scan_backward_kernel_matches_plain(cuda, bt, s, h, p, g, n,
                                                dtype):
    args = _bwd_inputs(cuda, bt, s, h, p, g, n, dtype, s + h + n)
    path = K3.backward_route(n, p, dtype)
    K3.reset_counts()
    got = K3.ssd_scan_backward(*args)
    want = K3.ssd_scan_backward_plain(*args[:7])
    torch.cuda.synchronize()
    assert K3.BWD_LAUNCHES == K3.BWD_ROUTE_LAUNCHES[path] == 1
    assert K3.LAUNCHES == 0
    for name, a, w, like in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                                args):
        assert a.dtype == like.dtype and a.shape == like.shape, name
        assert bool(torch.isfinite(a).all()), name
        err = _rel_l2(a, w)
        assert err <= BWD_TOL[dtype], (name, err)


@pytest.mark.parametrize("n,p,dtype", [(128, 64, torch.bfloat16),
                                       (128, 128, torch.float32),
                                       (16, 16, torch.bfloat16)])
def test_ssd_scan_backward_is_bitwise_repeatable(cuda, n, p, dtype):
    """Two calls on the same inputs give the same bits: the sums over a
    group's heads and over batch and sequence run in a fixed order."""
    args = _bwd_inputs(cuda, 2, 300, 8, p, 2, n, dtype, 5)
    one = K3.ssd_scan_backward(*args)
    two = K3.ssd_scan_backward(*args)
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def test_ssd_scan_backward_without_a_final_cotangent(cuda):
    """``dfinal=None`` is a zero cotangent, on both routes and types, and
    against the plain version."""
    for n, p, dtype in ((64, 64, torch.float32), (16, 16, torch.float32),
                        (128, 64, torch.bfloat16)):
        x, dt, A, B, C, dy, dfinal, states = _bwd_inputs(
            cuda, 1, 200, 12, p, 1, n, dtype, 6)
        got = K3.ssd_scan_backward(x, dt, A, B, C, dy, None, states)
        want = K3.ssd_scan_backward(x, dt, A, B, C, dy,
                                    torch.zeros_like(dfinal), states)
        plain = K3.ssd_scan_backward_plain(x, dt, A, B, C, dy, None)
        torch.cuda.synchronize()
        for a, b, w in zip(got, want, plain):
            assert torch.equal(a, b)
            assert _rel_l2(a, w) <= BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_kept_states_are_the_forwards(cuda, dtype):
    """The states ``ssd_scan(..., keep_states=True)`` hands the backward:
    slot c is, bit for bit, the final state K3's forward computes over
    the first c chunks, and y and the final state are the call's without
    them; the generic route keeps none."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    ins = _ssd_inputs(gen, 2, 300, 4, 64, 2, 128, dtype, cuda)
    y, final, states = K3.ssd_scan(*ins, keep_states=True)
    wy, wfinal = K3.ssd_scan(*ins)
    k = K3.inner_chunk(dtype)
    assert states.shape == (2, -(-300 // k), 4, 128, 64)
    assert torch.equal(y, wy) and torch.equal(final, wfinal)
    assert not states[:, 0].any()
    for c in range(1, states.shape[1]):
        head = [t[:, :c * k].contiguous() if t.dim() > 1 else t
                for t in ins]
        assert torch.equal(states[:, c], K3.ssd_scan(*head)[1]), c
    generic = _ssd_inputs(gen, 1, 50, 2, 16, 1, 16, dtype, cuda)
    assert K3.ssd_scan(*generic, keep_states=True)[2] is None


def test_ssd_scan_backward_needs_the_forwards_states(cuda):
    """The chunked route takes the forward's states and nothing else in
    their place; the generic route takes none."""
    x, dt, A, B, C, dy, dfinal, states = _bwd_inputs(
        cuda, 1, 200, 4, 64, 1, 128, torch.bfloat16, 8)
    K3.reset_counts()
    for bad in (None, states[:, :-1].contiguous(), states.double()):
        with pytest.raises(ValueError, match="states"):
            K3.ssd_scan_backward(x, dt, A, B, C, dy, dfinal, bad)
    g_args = _bwd_inputs(cuda, 1, 50, 2, 16, 1, 16, torch.float32, 8)
    with pytest.raises(ValueError, match="no states"):
        K3.ssd_scan_backward(*g_args[:7], states)
    assert K3.BWD_LAUNCHES == 0


def test_ssd_scan_raises_beyond_every_route(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    inputs = _ssd_inputs(gen, 1, 8, 2, 256, 1, 256, torch.float32, cuda)
    K3.reset_counts()
    with pytest.raises(ValueError, match="N, P"):
        K3.ssd_scan(*inputs)
    assert K3.LAUNCHES == 0


@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-27b", "mamba2-1.3b"])
def test_reduced_prefill_on_cuda_takes_the_generic_route(cuda, arch):
    """A reduced config's prefill on the card goes through K2/K3's generic
    route and matches the same float32 parameters' prefill on the CPU (the
    plain chunked paths) at 1e-4."""
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 70),
                           generator=torch.Generator().manual_seed(1))
    want, _, _ = TT.prefill(params, cfg, tokens, max_len=80)
    K2.reset_counts()
    K3.reset_counts()
    got, _, _ = TT.prefill(TT._to(params, cuda), cfg, tokens.to(cuda),
                           max_len=80)
    torch.cuda.synchronize()
    kernel = K3 if arch.startswith("mamba") else K2
    assert kernel.LAUNCHES == kernel.ROUTE_LAUNCHES["generic"] > 0
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


# MoE, MLA, the prefix and codebook stubs on the card (reduced, float32)

@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "arctic-480b",
                                  "jamba-1.5-large-398b"])
def test_moe_apply_on_cuda_matches_cpu(cuda, arch):
    """The MoE layer at a capacity factor that drops slots: the dispatch
    (experts, ranks, kept slots) equal to the CPU's, the output and aux
    loss at 1e-5."""
    from repro_torch.models import moe as TM
    cfg = dataclasses.replace(get_reduced_config(arch).moe,
                              capacity_factor=0.5)
    params = TM.make_moe_params(torch.Generator().manual_seed(0), cfg,
                                torch.float32)
    x = torch.randn((2, 40, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    want, want_aux = TM.moe_apply(params, cfg, x)
    got, got_aux = TM.moe_apply(TT._to(params, cuda), cfg, x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_aux.cpu(), want_aux, atol=1e-5, rtol=1e-5)
    t = x.shape[0] * x.shape[1]
    cap = TM.capacity(cfg, t)
    for dev in ("cpu", cuda):
        logits = x.reshape(t, -1).to(dev) @ params["router"].to(dev)
        idx = TM._router_probs(cfg, logits)[1]
        out = [a.cpu() for a in TM._dispatch(idx, cfg.n_experts, cap)]
        if dev == "cpu":
            ref = out
            assert not bool(out[2].all())         # slots were dropped
        else:
            for a, b in zip(out, ref):
                assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "arctic-480b",
                                  "jamba-1.5-large-398b", "musicgen-large",
                                  "paligemma-3b"])
def test_reduced_moe_mla_and_stub_models_on_cuda_match_cpu(cuda, arch):
    """Prefill and two decode steps of a reduced config on the card against
    the same float32 parameters on the CPU at 1e-4: MLA (plain attention on
    every device), MoE, prefix embeddings and codebooks; the GQA layers'
    prefills go through K2's generic route, jamba's SSD through K3's."""
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    gen = torch.Generator().manual_seed(1)
    shape = (2, 40, cfg.codebooks) if cfg.codebooks > 1 else (2, 40)
    tokens = torch.randint(0, cfg.vocab, shape, generator=gen)
    pe = (torch.randn((2, cfg.n_prefix, cfg.d_model), generator=gen) * 0.02
          if cfg.n_prefix else None)
    max_len = 48 + cfg.n_prefix
    want, want_c, n = TT.prefill(params, cfg, tokens, pe, max_len=max_len)
    K2.reset_counts()
    K3.reset_counts()
    on_card = TT._to(params, cuda)
    got, got_c, _ = TT.prefill(on_card, cfg, tokens.to(cuda),
                               None if pe is None else pe.to(cuda),
                               max_len=max_len)
    torch.cuda.synchronize()
    n_attn = sum(m.startswith("attn") for m, _ in cfg.pattern) * cfg.n_units
    assert K2.LAUNCHES == K2.ROUTE_LAUNCHES["generic"] == n_attn
    assert K3.LAUNCHES == K3.ROUTE_LAUNCHES["generic"] == sum(
        m == "mamba" for m, _ in cfg.pattern) * cfg.n_units
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    tok = want.argmax(-1)
    for i in range(2):
        want, want_c = TT.decode_step(params, cfg, tok, want_c, n + i)
        got, got_c = TT.decode_step(on_card, cfg, tok.to(cuda), got_c, n + i)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        tok = want.argmax(-1)


# K4: the GRU fit.  Inputs: the three regimes of
# benchmarks/beyond_rnn_predictor.py (periodic, drifting, bursty).

GRU_BUCKETS = (4, 8, 16, 32, 60)


def _gru_rows(seed, per_regime, n):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(per_regime):
        rows.append(3600 + rng.normal(0, 180, n))
        rows.append(600 + 8 * np.arange(n) + rng.normal(0, 40, n))
        rows.append(rng.choice([60.0, 300.0, 3600.0], n, p=[0.5, 0.3, 0.2])
                    * rng.lognormal(0, 0.2, n))
    return torch.from_numpy(np.asarray(rows, np.float32))


@pytest.mark.parametrize("n", GRU_BUCKETS)
def test_gru_fit_kernel_equals_plain_bitwise(cuda, n):
    """The kernel rounds every operation as the plain version's tensor ops
    do (``-fmad=false``, the 12-term sums in ``_rowsum``'s tree, the other
    sums in the plain order, PyTorch's sigmoid and tanh formulas), so on one
    card the forecasts are equal bit for bit."""
    y = _gru_rows(n, 8, n).to(cuda)
    p0 = init_params(0).to(cuda)
    K4.reset_counts()
    got = K4.gru_fit(y, p0, 150, 0.03)
    want = K4.gru_fit_plain(y, p0, 150, 0.03)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == 1
    assert torch.isfinite(want).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_gru_fit_kernel_rows_independent_of_launch(cuda):
    y = _gru_rows(5, 10, 16).to(cuda)
    p0 = init_params(3).to(cuda)
    full = K4.gru_fit(y, p0, 150, 0.03)
    rev = K4.gru_fit(y.flip(0).contiguous(), p0, 150, 0.03).flip(0)
    alone = torch.cat([K4.gru_fit(y[i:i + 1].contiguous(), p0, 150, 0.03)
                       for i in range(0, len(y), 7)])
    assert torch.equal(full.view(torch.int32), rev.view(torch.int32))
    assert torch.equal(full[::7].view(torch.int32), alone.view(torch.int32))


def test_gru_predictor_is_one_launch_per_forecast(cuda):
    series = _gru_rows(11, 1, 64)[2].numpy()       # bursty: no shortcut
    model = GRUPredictor(device=cuda)
    K4.reset_counts()
    got = model.forecast_next(series)
    assert K4.LAUNCHES == 1
    want = K4.gru_fit_plain(torch.from_numpy(series[-60:].copy()[None, :])
                            .to(cuda), model.params, 150, 0.03)
    assert got == float(want[0])


def test_gru_fit_launch_refuses_what_it_does_not_take(cuda):
    y = torch.zeros((2, 8), device=cuda)
    out = torch.zeros(2, device=cuda)
    p0 = torch.zeros(K4.N_PARAMS, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for rows, n, steps in ((2, 65, 1), (2, 1, 1), (0, 8, 1), (2, 8, -1)):
        assert K4._load().gru_fit_launch(y.data_ptr(), p0.data_ptr(),
                                         out.data_ptr(), rows, n, steps,
                                         0.03, stream) != 0


# ---------------------------------------------------------------------------
# training on the card: K2's and K3's entries return gradients through
# their backward kernels
# ---------------------------------------------------------------------------

def _kernel_args(cuda, kernel: str):
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(cuda)

    if kernel == "K2":
        return ops.flash_attention, K2, [
            rand(1, 64, 4, 64), rand(1, 64, 2, 64), rand(1, 64, 2, 64)]
    return ops.ssd_scan, K3, [
        rand(1, 64, 2, 64), torch.nn.functional.softplus(rand(1, 64, 2)),
        -torch.rand(2).to(cuda), rand(1, 64, 1, 64), rand(1, 64, 1, 64)]


@pytest.mark.parametrize("kernel", ["K2"])
@pytest.mark.parametrize("which", [0, -1])
def test_kernel_entry_refuses_an_input_that_requires_grad(cuda, kernel,
                                                          which):
    """K2's entry no longer refuses an input that requires grad: it
    differentiates through K2, one forward and one backward launch a call,
    the gradient equal to the plain backward's at float32's tolerance;
    under ``torch.no_grad`` and on detached inputs it runs the forward
    only."""
    fn, mod, args = _kernel_args(cuda, kernel)
    args[which].requires_grad_()
    mod.reset_counts()
    out = fn(*args)
    dout = torch.randn(out.shape, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    (grad,) = torch.autograd.grad(out, args[which], dout)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == 1 and mod.BWD_LAUNCHES == 1
    plain = [a.detach() for a in args]
    o, lse = K2.flash_attention_plain(*plain, return_lse=True)
    want = K2.flash_attention_backward_plain(*plain, o, lse, dout)[which]
    assert _rel_l2(grad, want) <= K2_BWD_TOL[torch.float32]
    with torch.no_grad():                   # nothing to differentiate
        fn(*args)
    fn(*(a.detach() for a in args))
    torch.cuda.synchronize()
    assert mod.LAUNCHES == 3 and mod.BWD_LAUNCHES == 1


@pytest.mark.parametrize("which", [0, 1, 2, -1])
def test_k3_entry_returns_gradients_through_its_backward(cuda, which):
    """An input of ``ops.ssd_scan`` that requires grad gets its gradient
    from K3's backward kernel (one forward and one backward launch), equal
    to the plain backward's at float32's tolerance."""
    fn, mod, args = _kernel_args(cuda, "K3")
    args[which].requires_grad_()
    mod.reset_counts()
    y, final = fn(*args)
    gen = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(y.shape, generator=gen, device=cuda)
    dfinal = torch.randn(final.shape, generator=gen, device=cuda)
    (grad,) = torch.autograd.grad((y * dy).sum() + (final * dfinal).sum(),
                                  args[which])
    want = K3.ssd_scan_backward_plain(*(a.detach() for a in args), dy,
                                      dfinal)[which]
    torch.cuda.synchronize()
    assert mod.LAUNCHES == 1 and mod.BWD_LAUNCHES == 1
    assert _rel_l2(grad, want) <= BWD_TOL[torch.float32]



# ---------------------------------------------------------------------------
# the Mamba block's kernels: K6 (causal conv + SiLU), K7 (D skip + gated
# norm), K8 (the decode's state step)
# ---------------------------------------------------------------------------

# bt, s, d_inner, heads, n, dtype: mamba2-1.3b's widths (a short sequence),
# the reduced configs' (d_inner 128, 8 heads of 16, N 16), ragged lengths
# and a d_inner that is not a multiple of a block of channels
MAMBA_SHAPES = [(2, 300, 4096, 64, 128, torch.bfloat16),
                (2, 64, 128, 8, 16, torch.float32),
                (2, 64, 128, 8, 16, torch.bfloat16),
                (3, 1, 128, 8, 16, torch.bfloat16),
                (1, 131, 200, 5, 24, torch.float32)]
# relative L2 where the kernel sums in another order than the plain
# version (dw, db, K7's row sums and its backward): float32; bf16 outputs
# (one bf16 ulp is 2^-8 relative)
MAMBA_REL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}


def _ordered(t):
    if t.dtype == torch.bfloat16:
        i = t.view(torch.int16).to(torch.int64)
        return torch.where(i < 0, -(i + (1 << 15)), i)
    i = t.view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i + (1 << 31)), i)


def _ulps_ordered(a, b) -> int:
    return int((_ordered(a) - _ordered(b)).abs().max())


def _conv_case(cuda, bt, s, di, n, dtype, seed, states=False):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda) * scale
                ).to(dtype)
    widths = (di, n, n)
    xs = [rnd(bt, s, c) for c in widths]
    ws = [rnd(4, c, scale=0.3) for c in widths]
    bs = [rnd(c, scale=0.1) for c in widths]
    sts = [rnd(bt, 3, c) for c in widths] if states else None
    gs = [rnd(bt, s, c, scale=1e-2) for c in widths]
    return xs, ws, bs, sts, gs


@pytest.mark.parametrize("bt,s,di,h,n,dtype", MAMBA_SHAPES)
@pytest.mark.parametrize("states", [False, True])
def test_conv_kernel_matches_plain(cuda, bt, s, di, h, n, dtype, states):
    """K6's forward over three segments against the plain conv: within one
    ulp (every op rounds as the plain version's), new states equal; two
    calls bitwise."""
    xs, ws, bs, sts, _ = _conv_case(cuda, bt, s, di, n, dtype, s + di,
                                    states)
    K6.reset_counts()
    ys, new = K6.causal_conv(xs, ws, bs, sts, want_state=True)
    ys2, new2 = K6.causal_conv(xs, ws, bs, sts, want_state=True)
    torch.cuda.synchronize()
    assert K6.LAUNCHES == 2
    for j, (x, w, b) in enumerate(zip(xs, ws, bs)):
        y, st = K6.causal_conv_plain(x, w, b, None if sts is None
                                     else sts[j])
        assert _ulps_ordered(ys[j], y) <= 1
        assert torch.equal(new[j], st)
        assert torch.equal(ys[j], ys2[j]) and torch.equal(new[j], new2[j])


@pytest.mark.parametrize("bt,s,di,h,n,dtype", MAMBA_SHAPES)
def test_conv_backward_kernel_matches_plain_bitwise_across_calls(
        cuda, bt, s, di, h, n, dtype):
    xs, ws, bs, _, gs = _conv_case(cuda, bt, s, di, n, dtype, 7 + s)
    K6.reset_counts()
    got = K6.causal_conv_backward(xs, ws, bs, gs)
    again = K6.causal_conv_backward(xs, ws, bs, gs)
    torch.cuda.synchronize()
    assert K6.BWD_LAUNCHES == 2
    for j, (x, w, b, g) in enumerate(zip(xs, ws, bs, gs)):
        want = K6.causal_conv_backward_plain(x, w, b, g)
        assert _ulps_ordered(got[0][j], want[0]) <= 1              # dx: same order
        for k in (1, 2):                                   # dw, db
            assert _rel_l2(got[k][j], want[k]) <= MAMBA_REL[dtype]
        for k in range(3):
            assert torch.equal(got[k][j], again[k][j])


def _norm_case(cuda, bt, s, di, h, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, dt=dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=cuda) * scale
                + shift).to(dt)
    return (rnd(bt, s, di), rnd(bt, s, di), rnd(bt, s, di),
            rnd(h, dt=torch.float32, scale=0.1, shift=1.0),
            rnd(di, dt=torch.float32, scale=0.1, shift=1.0),
            rnd(bt, s, di, scale=1e-2))


@pytest.mark.parametrize("bt,s,di,h,n,dtype", MAMBA_SHAPES)
@pytest.mark.parametrize("skip", [True, False])
def test_norm_kernel_matches_plain(cuda, bt, s, di, h, n, dtype, skip):
    y, xs, z, D, scale, _ = _norm_case(cuda, bt, s, di, h, dtype, di + s)
    if not skip:
        xs, D = None, None
    K7.reset_counts()
    out, rstd = K7.gated_norm(y, xs, z, D, scale)
    out2, rstd2 = K7.gated_norm(y, xs, z, D, scale)
    torch.cuda.synchronize()
    assert K7.LAUNCHES == 2
    want = K7.gated_norm_plain(y, xs, z, D, scale)
    if dtype == torch.bfloat16:
        assert _ulps_ordered(out, want) <= 1
    else:
        assert _rel_l2(out, want) <= MAMBA_REL[dtype]
    torch.testing.assert_close(rstd, K7.rstd_plain(y, xs, z, D), rtol=1e-6,
                               atol=0)
    assert torch.equal(out, out2) and torch.equal(rstd, rstd2)


@pytest.mark.parametrize("bt,s,di,h,n,dtype", MAMBA_SHAPES)
def test_norm_backward_kernel_matches_plain_bitwise_across_calls(
        cuda, bt, s, di, h, n, dtype):
    y, xs, z, D, scale, dout = _norm_case(cuda, bt, s, di, h, dtype, 3 + s)
    _, rstd = K7.gated_norm(y, xs, z, D, scale)
    K7.reset_counts()
    got = K7.gated_norm_backward(dout, y, xs, z, D, scale, rstd)
    again = K7.gated_norm_backward(dout, y, xs, z, D, scale, rstd)
    torch.cuda.synchronize()
    assert K7.BWD_LAUNCHES == 2
    want = K7.gated_norm_backward_plain(dout, y, xs, z, D, scale)
    for g, w, a in zip(got, want, again):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel_l2(g, w) <= MAMBA_REL[g.dtype]
        assert torch.equal(g, a)


# K8's decode shapes: mamba2-1.3b's and jamba's layers (MAMBA_CASES of
# chip_smoke.py), the reduced configs' (N = P = 16), B/C shared by 4 and by 2
# heads a group, and a head dim and state of no power of two
DECODE_SHAPES = [(1, 64, 64, 128, 1, torch.bfloat16),
                 (1, 64, 64, 128, 1, torch.float32),
                 (1, 128, 128, 128, 1, torch.bfloat16),
                 (1, 128, 128, 128, 1, torch.float32),
                 (2, 8, 16, 16, 1, torch.float32),
                 (2, 8, 16, 16, 1, torch.bfloat16),
                 (2, 8, 16, 16, 2, torch.bfloat16),
                 (2, 8, 16, 16, 4, torch.float32),
                 (1, 5, 40, 24, 1, torch.float32)]


def _decode_case(cuda, bt, h, p, n, g, dtype, seed) -> dict:
    """One token's inputs of K8: the projections, the conv weights, biases
    and states, the float32 state and the layer's vectors."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, dt=dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=cuda) * scale
                + shift).to(dt)
    widths = (h * p, g * n, g * n)
    f32 = torch.float32
    return {"xs": rnd(bt, 1, widths[0]), "B": rnd(bt, 1, widths[1]),
            "C": rnd(bt, 1, widths[2]), "dt": rnd(bt, 1, h),
            "ws": [rnd(4, c, scale=0.3) for c in widths],
            "bs": [rnd(c, scale=0.1) for c in widths],
            "states": [rnd(bt, 3, c) for c in widths],
            "ssm": rnd(bt, h, n, p, dt=f32),
            "vectors": (rnd(h, dt=f32, scale=0.5),
                        torch.log(torch.linspace(1.0, 16.0, h, device=cuda)),
                        rnd(h, dt=f32, scale=0.1, shift=1.0))}


def _decode_run(fn, c, states=None, ssm=None):
    """``fn`` (K8's wrapper or its plain version) on clones of the case's
    states, or on ``states`` and ``ssm`` as given: (y, states, ssm)."""
    states = [t.clone() for t in c["states"]] if states is None else states
    ssm = c["ssm"].clone() if ssm is None else ssm
    y = fn(c["xs"], c["B"], c["C"], c["dt"], c["ws"], c["bs"], states, ssm,
           *c["vectors"])
    return y, states, ssm


@pytest.mark.parametrize("bt,h,p,n,g,dtype", DECODE_SHAPES)
def test_decode_step_kernel_matches_plain(cuda, bt, h, p, n, g, dtype):
    """K8 (the layer's convs, dt, decay, state update and D skip) against
    its plain version: the new state and conv states bit for bit, y within
    one bf16 ulp (float32: the sum over N in another order, MAMBA_REL); two
    calls bitwise; the counters left zero."""
    c = _decode_case(cuda, bt, h, p, n, g, dtype, h + n + g)
    K8.reset_counts()
    y1, st1, s1 = _decode_run(K8.decode_layer, c)
    y2, st2, s2 = _decode_run(K8.decode_layer, c)
    torch.cuda.synchronize()
    assert K8.LAUNCHES == 2
    yp, stp, sp = _decode_run(K8.decode_layer_plain, c)
    assert torch.equal(s1, sp)
    assert all(torch.equal(a, b) for a, b in zip(st1, stp))
    if dtype == torch.bfloat16:
        assert _ulps_ordered(y1, yp) <= 1
    else:
        assert _rel_l2(y1, yp) <= MAMBA_REL[dtype]
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    assert all(torch.equal(a, b) for a, b in zip(st1, st2))
    assert not bool(K8._COUNTERS[torch.cuda.current_device()][-1].any())


def test_decode_layer_in_place_equals_a_call_on_clones(cuda):
    """K8 on the case's own states writes into them what a call on their
    clones gives, and returns nothing else: the states are its outputs."""
    c = _decode_case(cuda, 1, 64, 64, 128, 1, torch.bfloat16, 3)
    before = [t.clone() for t in c["states"] + [c["ssm"]]]
    want_y, want_st, want_s = _decode_run(K8.decode_layer, c)
    got_y, got_st, got_s = _decode_run(K8.decode_layer, c, c["states"],
                                       c["ssm"])
    assert got_s is c["ssm"] and all(a is b for a, b in zip(got_st,
                                                              c["states"]))
    assert torch.equal(got_y, want_y) and torch.equal(got_s, want_s)
    assert all(torch.equal(a, b) for a, b in zip(got_st, want_st))
    assert not any(torch.equal(a, b) for a, b in zip(
        got_st + [got_s], before))


@pytest.mark.parametrize("g", [4, 2])
def test_decode_layer_graph_replays_bitwise_with_shared_group_states(cuda,
                                                                    g):
    """B and C's conv state shared by 2 and by 4 heads a group, written by
    the group's last reader: a call captured in a CUDA graph and replayed
    twice from the same states gives the eager call's bits each time, two
    steps in a row equal two eager steps, and the counters end zero."""
    c = _decode_case(cuda, 2, 8, 16, 16, g, torch.bfloat16, 20 + g)
    want = _decode_run(K8.decode_layer, c)
    want2 = _decode_run(K8.decode_layer, c, *[[t.clone() for t in want[1]],
                                              want[2].clone()])
    states = [t.clone() for t in c["states"]]
    ssm = c["ssm"].clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = _decode_run(K8.decode_layer, c, states, ssm)[0]
    for _ in range(2):
        for t, t0 in zip(states + [ssm], c["states"] + [c["ssm"]]):
            t.copy_(t0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want[0]) and torch.equal(ssm, want[2])
        assert all(torch.equal(a, b) for a, b in zip(states, want[1]))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want2[0]) and torch.equal(ssm, want2[2])
    assert all(torch.equal(a, b) for a, b in zip(states, want2[1]))
    assert not bool(K8._COUNTERS[torch.cuda.current_device()][-1].any())


def test_conv_and_norm_entries_return_gradients_through_their_kernels(cuda):
    """``ops.causal_conv`` and ``ops.gated_norm`` on inputs that require
    grad run K6 and K7 forward and backward (one launch each way), and
    autograd's gradients are the backward kernels' own."""
    xs, ws, bs, _, gs = _conv_case(cuda, 2, 64, 128, 16, torch.float32, 5)
    leaves = [t.clone().requires_grad_() for t in xs + ws + bs]
    K6.reset_counts()
    ys, new = ops.causal_conv(leaves[:3], leaves[3:6], leaves[6:])
    assert new is None
    torch.autograd.backward(ys, gs)
    want = K6.causal_conv_backward(xs, ws, bs, gs)
    torch.cuda.synchronize()
    assert K6.LAUNCHES == 1 and K6.BWD_LAUNCHES == 2
    for t, w in zip(leaves, [w for ls in want for w in ls]):
        assert torch.equal(t.grad, w)
    y, x, z, D, scale, dout = _norm_case(cuda, 2, 16, 128, 8, torch.float32,
                                         6)
    leaves = [t.clone().requires_grad_() for t in (y, x, z, D, scale)]
    K7.reset_counts()
    ops.gated_norm(*leaves).backward(dout)
    _, rstd = K7.gated_norm(y, x, z, D, scale)
    want = K7.gated_norm_backward(dout, y, x, z, D, scale, rstd)
    torch.cuda.synchronize()
    assert K7.LAUNCHES == 2 and K7.BWD_LAUNCHES == 2
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


def test_mamba_train_and_decode_run_the_block_kernels(cuda):
    """Reduced mamba2 on the card: ``train_loop`` (the warm-up step, then
    one captured step replayed) calls K6 and K7 forward once a layer (twice
    with the remat recompute) and backward once, in the warm-up and the
    capture only; a prefill calls each once a layer; a captured decode
    calls K8 and K7 once a layer, in its warm-up and its capture, and K6
    never (K8 runs the decode's convs)."""
    from repro_torch.serve.engine import DecodeProgram
    from repro_torch.train import loop as TL
    cfg = get_reduced_config("mamba2-1.3b")
    layers = cfg.n_layers
    fwd = 2 * layers * (1 if cfg.remat == "none" else 2)
    for mod in (K6, K7, K8):
        mod.reset_counts()
    TL.train_loop(cfg, TL.TrainConfig(), iter(_train_batches(cfg, 3)), 3,
                  device=cuda)
    torch.cuda.synchronize()
    assert (K6.LAUNCHES, K6.BWD_LAUNCHES) == (fwd, 2 * layers)
    assert (K7.LAUNCHES, K7.BWD_LAUNCHES) == (fwd, 2 * layers)
    assert K8.LAUNCHES == 0
    params = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            cuda)
    toks = torch.arange(20, device=cuda)[None] % cfg.vocab
    with torch.no_grad():
        logits, caches, n = TT.prefill(params, cfg, toks, max_len=40)
    assert K6.LAUNCHES == K7.LAUNCHES == fwd + layers
    program = DecodeProgram(params, cfg, caches, logits[0].argmax(-1))
    program.decode(caches, logits[0].argmax(-1), n, 8)
    torch.cuda.synchronize()
    assert K8.LAUNCHES == 2 * layers
    assert K6.LAUNCHES == fwd + layers and K7.LAUNCHES == fwd + 3 * layers


def test_block_kernels_raise_on_what_they_do_not_take(cuda):
    """No plain version stands in for a kernel: shapes, types and a launch
    the kernels refuse raise, and so does a build that fails."""
    from repro_torch.kernels import nvcc
    xs, ws, bs, _, _ = _conv_case(cuda, 1, 8, 32, 8, torch.float32, 9)
    with pytest.raises(ValueError, match="K <="):
        K6.causal_conv(xs[:1], [torch.zeros(9, 32, device=cuda)], bs[:1])
    with pytest.raises(TypeError):
        K6.causal_conv([x.half() for x in xs], [w.half() for w in ws],
                       [b.half() for b in bs])
    with pytest.raises(ValueError, match="contiguous"):
        K6.causal_conv([torch.zeros(1, 8, 64, device=cuda)[..., ::2]],
                       ws[:1], bs[:1])
    with pytest.raises(RuntimeError, match="launch failed"):
        nvcc.check_launch("causal_conv", K6._load().conv_fwd_launch(
            0, 0, 1, 8, 4, None, None, None, None, None, None, None,
            torch.cuda.current_stream().cuda_stream))
    y, x, z, D, scale, _ = _norm_case(cuda, 1, 4, 32, 3, torch.float32, 1)
    with pytest.raises(ValueError, match="dividing"):
        K7.gated_norm(y, x, z, D, scale)
    with pytest.raises(ValueError, match="rstd"):
        K7.gated_norm_backward(y, y, x, z, torch.ones(4, device=cuda), scale,
                               None)
    leaves = [t.requires_grad_() for t in (y, z)]
    with pytest.raises(RuntimeError, match="no backward"):
        ops.gated_norm(leaves[0], None, leaves[1], None, scale)
    c = _decode_case(cuda, 1, 4, 8, 16, 1, torch.float32, 4)
    with pytest.raises(ValueError, match="must be a contiguous"):
        _decode_run(K8.decode_layer, c, [t.transpose(1, 2).contiguous()
                                         .transpose(1, 2)
                                         for t in c["states"]])
    for p, n in ((6, 16), (8, 300)):
        with pytest.raises(ValueError, match="takes K=4"):
            _decode_run(K8.decode_layer, _decode_case(
                cuda, 1, 4, p, n, 1, torch.float32, 4))
    with pytest.raises(ValueError, match="takes K=4"):
        _decode_run(K8.decode_layer, dict(c, ws=[w[:3] for w in c["ws"]],
                                          states=[t[:, :2] for t in
                                                  c["states"]]))
    with pytest.raises(TypeError):
        _decode_run(K8.decode_layer, {k: [t.half() for t in v]
                                      if isinstance(v, list) else v.half()
                                      if k != "vectors" else v
                                      for k, v in c.items()})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        nvcc.start("mamba_decode", ("--no-such-nvcc-flag",)).wait()
    assert _decode_run(K8.decode_layer, c)[0].shape == (1, 4, 8)


def _offset(t, shift: int):
    """``t``'s values in a contiguous view ``shift`` elements into a fresh
    buffer (``shift`` 1: not on a 16-byte boundary)."""
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    view = buf[shift:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("widths,dtype", [
    ((4096, 128, 128), torch.bfloat16), ((200, 24, 24), torch.bfloat16),
    ((100, 20, 20), torch.bfloat16), ((200, 24, 24), torch.float32),
    ((202, 22, 22), torch.float32)])
def test_conv_kernel_routes_match_plain(cuda, widths, dtype, shift):
    """K6 on the route its wrapper names: chunks of 16-byte vectors where
    every segment is whole vectors and every tensor starts on a 16-byte
    boundary, else one channel a thread (widths of 100 / 20 bf16 or 202 /
    22 float32, or inputs one element into their buffers).  The forward
    within an ulp of the plain version with its new states equal, the
    backward's dx within an ulp and dw, db within ``MAMBA_REL``; two calls
    bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(sum(widths) + shift)

    def rnd(*shape, scale=1.0):
        t = (torch.randn(shape, generator=gen, device=cuda) * scale
             ).to(dtype)
        return _offset(t, shift)
    xs = [rnd(2, 67, c) for c in widths]
    ws = [rnd(4, c, scale=0.3) for c in widths]
    bs = [rnd(c, scale=0.1) for c in widths]
    sts = [rnd(2, 3, c) for c in widths]
    gs = [rnd(2, 67, c, scale=1e-2) for c in widths]
    whole = all(c % (16 // dtype.itemsize) == 0 for c in widths)
    way = "vector" if whole and not shift else "scalar"
    assert K6.route(widths, dtype, xs + ws + bs + sts + gs) == way
    K6.reset_counts()
    ys, new = K6.causal_conv(xs, ws, bs, sts, want_state=True)
    again = K6.causal_conv(xs, ws, bs, sts, want_state=True)
    got = K6.causal_conv_backward(xs, ws, bs, gs)
    got2 = K6.causal_conv_backward(xs, ws, bs, gs)
    torch.cuda.synchronize()
    assert K6.ROUTE_LAUNCHES == {way: 4, ("scalar" if way == "vector"
                                          else "vector"): 0}
    for j, (x, w, b, g) in enumerate(zip(xs, ws, bs, gs)):
        y, st = K6.causal_conv_plain(x, w, b, sts[j])
        assert _ulps_ordered(ys[j], y) <= 1
        assert torch.equal(new[j], st)
        assert torch.equal(ys[j], again[0][j])
        want = K6.causal_conv_backward_plain(x, w, b, g)
        assert _ulps_ordered(got[0][j], want[0]) <= 1
        for k in (1, 2):
            assert _rel_l2(got[k][j], want[k]) <= MAMBA_REL[dtype]
        for k in range(3):
            assert torch.equal(got[k][j], got2[k][j])


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("rows,di,h,dtype", [
    (37, 4096, 64, torch.bfloat16), (37, 200, 5, torch.bfloat16),
    (37, 202, 2, torch.bfloat16), (37, 200, 5, torch.float32),
    (37, 4096, 64, torch.float32)])
def test_norm_kernel_routes_match_plain(cuda, rows, di, h, dtype, shift):
    """K7 on the route its wrapper names (vectors where a row is whole
    16-byte vectors and every tensor 16-byte aligned, else the same chunks
    element by element: a width of 202 bf16, inputs one element into their
    buffers; float32 rows of 4096 take a cluster of two blocks in the
    backward): the forward within an ulp (bf16) or ``MAMBA_REL`` of the
    plain version, the backward within ``MAMBA_REL``; two calls bitwise."""
    y, xs, z, D, scale, dout = _norm_case(cuda, 1, rows, di, h, dtype,
                                          di + shift)
    y, xs, z, dout = (_offset(t, shift) for t in (y, xs, z, dout))
    way = "vector" if di % (16 // dtype.itemsize) == 0 and not shift \
        else "scalar"
    assert K7.route(di, dtype, (y, xs, z, dout, scale)) == way
    K7.reset_counts()
    out, rstd = K7.gated_norm(y, xs, z, D, scale)
    out2, _ = K7.gated_norm(y, xs, z, D, scale)
    got = K7.gated_norm_backward(dout, y, xs, z, D, scale, rstd)
    again = K7.gated_norm_backward(dout, y, xs, z, D, scale, rstd)
    torch.cuda.synchronize()
    assert K7.ROUTE_LAUNCHES[way] == 4
    want = K7.gated_norm_plain(y, xs, z, D, scale)
    if dtype == torch.bfloat16:
        assert _ulps_ordered(out, want) <= 1
    else:
        assert _rel_l2(out, want) <= MAMBA_REL[dtype]
    assert torch.equal(out, out2)
    for g, w, a in zip(got, K7.gated_norm_backward_plain(
            dout, y, xs, z, D, scale), again):
        assert _rel_l2(g, w) <= MAMBA_REL[g.dtype]
        assert torch.equal(g, a)


@pytest.mark.parametrize("rows", [1, 3])
def test_norm_backward_with_fewer_rows_than_blocks(cuda, rows):
    """K7's backward over 1 and 3 rows (fewer than the card's clusters):
    within ``MAMBA_REL`` of the plain version, two calls bitwise."""
    y, xs, z, D, scale, dout = _norm_case(cuda, 1, rows, 4096, 64,
                                          torch.bfloat16, rows)
    _, rstd = K7.gated_norm(y, xs, z, D, scale)
    got = K7.gated_norm_backward(dout, y, xs, z, D, scale, rstd)
    again = K7.gated_norm_backward(dout, y, xs, z, D, scale, rstd)
    torch.cuda.synchronize()
    for g, w, a in zip(got, K7.gated_norm_backward_plain(
            dout, y, xs, z, D, scale), again):
        assert _rel_l2(g, w) <= MAMBA_REL[g.dtype]
        assert torch.equal(g, a)


def test_norm_at_jamba_width_matches_plain(cuda):
    """K7 forward and backward over rows of jamba-1.5-large-398b's d_inner
    (16384, 128 heads of 128; the backward a cluster of four blocks a row)
    against the plain versions."""
    y, xs, z, D, scale, dout = _norm_case(cuda, 1, 96, 16384, 128,
                                          torch.bfloat16, 16384)
    out, rstd = K7.gated_norm(y, xs, z, D, scale)
    got = K7.gated_norm_backward(dout, y, xs, z, D, scale, rstd)
    torch.cuda.synchronize()
    assert _ulps_ordered(out, K7.gated_norm_plain(y, xs, z, D, scale)) <= 1
    for g, w in zip(got, K7.gated_norm_backward_plain(dout, y, xs, z, D,
                                                      scale)):
        assert _rel_l2(g, w) <= MAMBA_REL[g.dtype]


def test_norm_sum_then_finish_gives_fused_bits(cuda, monkeypatch):
    """The split modes around an all-reduce over one rank (the all-reduce
    an identity here): SUM's row sums fed to FINISH give the FUSED call's
    bits, forward (out, rstd) and backward (all five gradients), at
    mamba2-1.3b's width."""
    y, xs, z, D, scale, dout = _norm_case(cuda, 1, 300, 4096, 64,
                                          torch.bfloat16, 11)
    fused, rstd = K7.gated_norm(y, xs, z, D, scale)
    grads = K7.gated_norm_backward(dout, y, xs, z, D, scale, rstd)
    monkeypatch.setattr(K7, "_all_reduce", lambda t, group: t)
    split, rstd2 = K7.gated_norm(y, xs, z, D, scale, group=object(),
                                 width=4096)
    grads2 = K7.gated_norm_backward(dout, y, xs, z, D, scale, rstd,
                                    group=object(), width=4096)
    torch.cuda.synchronize()
    assert torch.equal(split, fused) and torch.equal(rstd2, rstd)
    for a, b in zip(grads2, grads):
        assert torch.equal(a, b)


def test_block_backwards_replay_bitwise(cuda):
    """K6's and K7's backwards captured in a CUDA graph: a replay gives the
    eager call's bits (the slot sums run in a fixed order)."""
    xs, ws, bs, _, gs = _conv_case(cuda, 2, 300, 4096, 128, torch.bfloat16,
                                   21)
    y, x, z, D, scale, dout = _norm_case(cuda, 2, 300, 4096, 64,
                                         torch.bfloat16, 22)
    _, rstd = K7.gated_norm(y, x, z, D, scale)

    def both():
        return ([t for ls in K6.causal_conv_backward(xs, ws, bs, gs)
                 for t in ls]
                + list(K7.gated_norm_backward(dout, y, x, z, D, scale,
                                              rstd)))
    eager = both()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = both()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the unit's kernels: K9 (residual add + RMSNorm) and K10 (SwiGLU gate)
# ---------------------------------------------------------------------------


def _unit_rnd(cuda, shape, dtype, seed, offset=0, scale=1.0, shift=0.0):
    """A tensor of ``shape`` ``offset`` elements into a buffer of its own
    (an offset of one puts it off a 16-byte boundary)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n = int(np.prod(shape))
    buf = (torch.randn(n + offset, generator=gen, device=cuda) * scale
           + shift).to(dtype)
    return buf[offset:].view(*shape)


# rows, width, dtype, offset, route: yi-6b's and mamba2-1.3b's widths,
# deepseek-v3's 7168 at one row (the decode's), float32, a width that is
# not whole vectors and a view off a 16-byte boundary
UNIT_NORM_CASES = [(64, 4096, torch.bfloat16, 0, "vector"),
                   (300, 2048, torch.bfloat16, 0, "vector"),
                   (1, 7168, torch.bfloat16, 0, "vector"),
                   (33, 4096, torch.float32, 0, "vector"),
                   (5, 4100, torch.bfloat16, 0, "scalar"),
                   (7, 2048, torch.bfloat16, 1, "scalar"),
                   (3, 16384, torch.bfloat16, 0, "vector"),
                   (3, 8192, torch.float32, 0, "vector")]


@pytest.mark.parametrize("rows,w,dtype,offset,route", UNIT_NORM_CASES)
@pytest.mark.parametrize("with_h", [True, False])
def test_unit_norm_kernel_matches_plain(cuda, rows, w, dtype, offset, route,
                                        with_h):
    """K9's forward against its plain version: ``s`` bit for bit, ``y``
    within one bf16 ulp (float32: 1e-5 relative L2; the row's sum of
    squares in another order), ``rstd`` the plain one's within 1e-5; the
    route the widths and pointers give; two calls bitwise."""
    from repro_torch.kernels import unit_norm as K9
    x = _unit_rnd(cuda, (rows, w), dtype, 1, offset)
    h = _unit_rnd(cuda, (rows, w), dtype, 2, offset) if with_h else None
    scale = _unit_rnd(cuda, (w,), torch.float32, 3, offset, 0.1, 1.0)
    before = dict(K9.ROUTE_LAUNCHES)
    s, y, rstd = K9.add_rmsnorm(x, h, scale)
    assert K9.ROUTE_LAUNCHES[route] == before[route] + 1
    ps, py = K9.add_rmsnorm_plain(x, h, scale)
    assert torch.equal(s, ps) and (with_h or s is x)
    if dtype == torch.bfloat16:
        assert _ulps_ordered(y, py) <= 1
    else:
        assert _rel_l2(y, py) <= 1e-5
    assert _rel_l2(rstd, K9.rstd_plain(ps)) <= 1e-5
    s2, y2, r2 = K9.add_rmsnorm(x, h, scale)
    assert torch.equal(s, s2) and torch.equal(y, y2) and torch.equal(rstd,
                                                                     r2)


@pytest.mark.parametrize("rows,w,dtype,offset,route", UNIT_NORM_CASES[:6])
@pytest.mark.parametrize("with_ds", [True, False])
def test_unit_norm_backward_matches_plain_and_replays_bitwise(
        cuda, rows, w, dtype, offset, route, with_ds):
    """K9's backward against its plain version (``d`` 4e-3 relative L2 in
    bf16, 1e-5 in float32: the row dot in another order; ``dscale`` 1e-5,
    its sum over rows in another order), two calls and a replay of a
    captured call bit for bit (fixed-order slot sums)."""
    from repro_torch.kernels import unit_norm as K9
    x = _unit_rnd(cuda, (rows, w), dtype, 4, offset)
    h = _unit_rnd(cuda, (rows, w), dtype, 5, offset)
    scale = _unit_rnd(cuda, (w,), torch.float32, 6, offset, 0.1, 1.0)
    dy = _unit_rnd(cuda, (rows, w), dtype, 7, offset, 1e-2)
    ds = _unit_rnd(cuda, (rows, w), dtype, 8, offset, 1e-2) if with_ds \
        else None
    s, _, rstd = K9.add_rmsnorm(x, h, scale)
    d, dscale = K9.add_rmsnorm_backward(dy, ds, s, scale, rstd)
    pd, pdscale = K9.add_rmsnorm_backward_plain(dy, ds, s, scale, rstd)
    assert _rel_l2(d, pd) <= (4e-3 if dtype == torch.bfloat16 else 1e-5)
    assert _rel_l2(dscale, pdscale) <= 1e-5
    again = K9.add_rmsnorm_backward(dy, ds, s, scale, rstd)
    assert torch.equal(d, again[0]) and torch.equal(dscale, again[1])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = K9.add_rmsnorm_backward(dy, ds, s, scale, rstd)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured[0], d) and torch.equal(captured[1], dscale)


@pytest.mark.parametrize("shape,dtype,offset,route", [
    ((4, 256, 11008), torch.bfloat16, 0, "vector"),
    ((1, 1, 18432), torch.bfloat16, 0, "vector"),
    ((3, 77, 96), torch.float32, 0, "vector"),
    ((2, 5, 1030), torch.bfloat16, 1, "scalar"),
    ((3, 333), torch.bfloat16, 0, "scalar")])
def test_swiglu_gate_kernel_matches_plain_and_replays_bitwise(
        cuda, shape, dtype, offset, route):
    """K10 forward and backward against their plain versions: within one
    ulp element by element in bf16 (the same ops, each rounded to bf16);
    in float32 the forward within one ulp and the backward within 1e-6
    relative L2 (torch's compiled silu_backward contracts a multiply and
    an add into an FMA, the kernel rounds each: a few float32 ulps, and
    more relative to ``dg`` near silu's stationary point, where it nears
    zero); two calls and a replay of a captured call bit for bit."""
    from repro_torch.kernels import swiglu_gate as K10
    g = _unit_rnd(cuda, shape, dtype, 9, offset, 3.0)
    u = _unit_rnd(cuda, shape, dtype, 10, offset)
    dh = _unit_rnd(cuda, shape, dtype, 11, offset, 1e-2)
    before = dict(K10.ROUTE_LAUNCHES)
    h = K10.swiglu_gate(g, u)
    assert K10.ROUTE_LAUNCHES[route] == before[route] + 1
    assert _ulps_ordered(h, K10.swiglu_gate_plain(g, u)) <= 1
    dg, du = K10.swiglu_gate_backward(dh, g, u)
    pdg, pdu = K10.swiglu_gate_backward_plain(dh, g, u)
    if dtype == torch.bfloat16:
        assert _ulps_ordered(dg, pdg) <= 1 and _ulps_ordered(du, pdu) <= 1
    else:
        assert _rel_l2(dg, pdg) <= 1e-6 and _ulps_ordered(du, pdu) <= 1
    assert torch.equal(h, K10.swiglu_gate(g, u))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = (K10.swiglu_gate(g, u),
                    *K10.swiglu_gate_backward(dh, g, u))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, (h, dg, du)))


def test_unit_entries_give_gradients_through_the_kernels(cuda):
    """``ops.add_rmsnorm`` and ``ops.swiglu_gate`` under autograd run the
    kernels both ways: the gradients of ``x``, ``h`` (one tensor) and
    ``scale`` and of ``g``, ``u`` equal the backward kernels' on the same
    cotangents."""
    from repro_torch.kernels import swiglu_gate as K10
    from repro_torch.kernels import unit_norm as K9
    x, h, dy, ds = (_unit_rnd(cuda, (2, 9, 256), torch.bfloat16, k)
                    for k in range(20, 24))
    scale = _unit_rnd(cuda, (256,), torch.float32, 24, 0, 0.1, 1.0)
    leaves = [t.clone().requires_grad_() for t in (x, h, scale)]
    K9.reset_counts()
    s, y = ops.add_rmsnorm(*leaves)
    torch.autograd.backward((s, y), (ds, dy))
    assert (K9.LAUNCHES, K9.BWD_LAUNCHES) == (1, 1)
    _, _, rstd = K9.add_rmsnorm(x, h, scale)
    d, dscale = K9.add_rmsnorm_backward(dy, ds, s.detach(), scale, rstd)
    assert torch.equal(leaves[0].grad, d) and torch.equal(leaves[1].grad, d)
    assert torch.equal(leaves[2].grad, dscale)
    g, u, dh = (_unit_rnd(cuda, (2, 9, 352), torch.bfloat16, k)
                for k in range(25, 28))
    gl = [t.clone().requires_grad_() for t in (g, u)]
    K10.reset_counts()
    ops.swiglu_gate(*gl).backward(dh)
    assert (K10.LAUNCHES, K10.BWD_LAUNCHES) == (1, 1)
    dg, du = K10.swiglu_gate_backward(dh, g, u)
    assert torch.equal(gl[0].grad, dg) and torch.equal(gl[1].grad, du)


def test_unit_kernels_raise_on_what_they_do_not_take(cuda):
    """No plain version stands in for a kernel: types, shapes, widths and
    layouts the kernels refuse raise."""
    from repro_torch.kernels import swiglu_gate as K10
    from repro_torch.kernels import unit_norm as K9
    x = torch.zeros(2, 64, device=cuda)
    sc = torch.ones(64, device=cuda)
    with pytest.raises(TypeError):
        K9.add_rmsnorm(x.half(), None, sc)
    with pytest.raises(ValueError, match="scale"):
        K9.add_rmsnorm(x, None, sc.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        K9.add_rmsnorm(torch.zeros(2, 128, device=cuda)[:, ::2], None, sc)
    with pytest.raises(ValueError, match="at most"):
        K9.add_rmsnorm(torch.zeros(1, 8196, device=cuda), None,
                       torch.ones(8196, device=cuda))
    with pytest.raises(ValueError, match="rstd"):
        K9.add_rmsnorm_backward(x, None, x, sc, None)
    with pytest.raises(ValueError):
        K9.add_rmsnorm(x, x.bfloat16(), sc)
    with pytest.raises(TypeError):
        K10.swiglu_gate(x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        K10.swiglu_gate(x.t(), x.t())
    with pytest.raises(ValueError):
        K10.swiglu_gate(x, x.bfloat16())


def test_unit_kernels_in_the_train_loop_and_the_decode(cuda):
    """Reduced yi-6b on the card: ``train_loop`` calls K9 once a norm (the
    units' twice with the remat recompute) and K10 once a layer (twice),
    each backward once, in the warm-up and the capture only; a prefill
    calls K9 once a norm and K10 once a layer; a captured decode calls
    them in its warm-up and its capture, and its tokens equal the eager
    loop's."""
    from repro_torch.kernels import swiglu_gate as K10
    from repro_torch.kernels import unit_norm as K9
    from repro_torch.serve.engine import DecodeProgram
    from repro_torch.train import loop as TL
    cfg = get_reduced_config("yi-6b")
    layers = cfg.n_layers
    passes = 1 if cfg.remat == "none" else 2
    for mod in (K9, K10):
        mod.reset_counts()
    TL.train_loop(cfg, TL.TrainConfig(), iter(_train_batches(cfg, 3)), 3,
                  device=cuda)
    torch.cuda.synchronize()
    assert (K9.LAUNCHES, K9.BWD_LAUNCHES) == (
        2 * (2 * layers * passes + 1), 2 * (2 * layers + 1))
    assert (K10.LAUNCHES, K10.BWD_LAUNCHES) == (2 * layers * passes,
                                                2 * layers)
    params = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            cuda)
    toks = torch.arange(20, device=cuda)[None] % cfg.vocab
    for mod in (K9, K10):
        mod.reset_counts()
    with torch.no_grad():
        logits, caches, n = TT.prefill(params, cfg, toks, max_len=40)
    assert (K9.LAUNCHES, K10.LAUNCHES) == (2 * layers + 1, layers)
    program = DecodeProgram(params, cfg, caches, logits[0].argmax(-1))
    got = program.decode(caches, logits[0].argmax(-1), n, 8)
    torch.cuda.synchronize()
    assert (K9.LAUNCHES, K10.LAUNCHES) == (3 * (2 * layers + 1),
                                           3 * layers)
    assert K9.BWD_LAUNCHES == K10.BWD_LAUNCHES == 0
    with torch.no_grad():
        logits, caches, n = TT.prefill(params, cfg, toks, max_len=40)
        tok, want = logits.argmax(-1), []
        for i in range(8):
            want.append(tok[0])
            step, caches = TT.decode_step(params, cfg, tok, caches, n + i)
            tok = step.argmax(-1)
    assert torch.equal(got, torch.stack(want))


# ---------------------------------------------------------------------------
# the serving engine's decode program captured in a CUDA graph (before the
# mesh tests, whose NCCL group starts a watchdog thread)
# ---------------------------------------------------------------------------

GRAPH_ARCHS = ["yi-6b", "gemma3-27b", "mamba2-1.3b", "deepseek-v3-671b",
               "jamba-1.5-large-398b", "musicgen-large", "paligemma-3b"]


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graph_decode_matches_eager_decode(cuda, arch):
    """A reduced config's decode program captured on the card against the
    eager per-token loop (int positions) from the same prefill, 16 steps:
    tokens equal, every step's logits bitwise; the prefill's caches are
    left as they were."""
    from repro_torch.serve.engine import DecodeProgram
    cfg = get_reduced_config(arch)
    params = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    shape = (1, 20, cfg.codebooks) if cfg.codebooks > 1 else (1, 20)
    toks = torch.randint(0, cfg.vocab, shape, generator=gen, device=cuda)
    pe = (torch.zeros((1, cfg.n_prefix, cfg.d_model), dtype=cfg.dtype,
                      device=cuda) if cfg.n_prefix else None)
    logits, caches, n = TT.prefill(params, cfg, toks, pe,
                                   max_len=40 + cfg.n_prefix)
    kept = [t.clone() for t in torch.utils._pytree.tree_leaves(caches)]
    tok0 = logits[0].argmax(-1)
    program = DecodeProgram(params, cfg, caches, tok0)
    got = program.decode(caches, tok0, n, 16)
    assert program.graph is not None and program.capture_seconds > 0
    program.load(caches, tok0, n)
    got_logits = []
    for _ in range(16):
        program.advance()
        got_logits.append(program.logits.clone())
    assert all(torch.equal(a, b) for a, b in zip(
        kept, torch.utils._pytree.tree_leaves(caches)))
    tok, want = logits.argmax(-1), []
    for i in range(16):
        want.append(tok[0])
        step_logits, caches = TT.decode_step(params, cfg, tok, caches, n + i)
        assert torch.equal(got_logits[i], step_logits), i
        tok = step_logits.argmax(-1)
    assert torch.equal(got, torch.stack(want))


def test_serve_on_cuda_replays_one_graph_per_engine(cuda):
    """``ServeEngine.serve`` on the card captures its decode step at the
    first request and replays that graph for every later one; its tokens
    equal the eager loop's."""
    from repro_torch.serve import engine as TE
    cfg = get_reduced_config("yi-6b")
    params = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            cuda)
    engine = TE.ServeEngine(cfg, params, max_len=40, device=cuda)
    graphs = []
    for i in range(4):
        prompt = (np.arange(24) * (i % 3 + 3)) % cfg.vocab
        comp = engine.serve(TE.Request(i, i % 3, 20.0 * i, prompt, 8),
                            20.0 * i)
        graphs.append(engine.program.graph)
        logits, caches, n = engine._prefill(prompt)
        tok, want = logits.argmax(-1), []
        for j in range(8):
            want.append(int(tok[0]))
            step_logits, caches = TT.decode_step(params, cfg, tok, caches,
                                                 n + j)
            tok = step_logits.argmax(-1)
        assert comp.tokens == want, i
    assert graphs[0] is not None and all(g is graphs[0] for g in graphs)


def test_graph_capture_that_meets_a_host_sync_raises(cuda, monkeypatch):
    """A decode step that reads a value back to the host cannot be
    captured: ``serve`` raises and leaves no graph, and no eager decode
    takes its place."""
    from repro_torch.serve import engine as TE
    cfg = get_reduced_config("yi-6b")
    params = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            cuda)
    inner = TE.decode_step

    def syncing(p, c, tok, caches, pos):
        logits, caches = inner(p, c, tok, caches, pos)
        float(logits.sum())                      # a host read-back
        return logits, caches

    monkeypatch.setattr(TE, "decode_step", syncing)
    engine = TE.ServeEngine(cfg, params, max_len=40, device=cuda)
    with pytest.raises(RuntimeError):
        engine.serve(TE.Request(0, 0, 0.0, np.arange(24) % cfg.vocab, 4),
                     0.0)
    torch.cuda.synchronize()
    assert engine.program.graph is None
    assert engine.program.capture_seconds is None


# ---------------------------------------------------------------------------
# the train loop's step captured in a CUDA graph
# ---------------------------------------------------------------------------

def _train_batches(cfg, n: int):
    from repro_torch.data.pipeline import SyntheticLM
    src = SyntheticLM(vocab=cfg.vocab, seq_len=64, batch=4, n_shards=8)
    return [src.batch_from_shard(src.load_shard(i)) for i in range(n)]


def _bits(tree):
    return [t.view(torch.uint8) if t.dim() else t
            for t in torch.utils._pytree.tree_leaves(tree)]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b",
                                  "yi-6b"])
def test_graph_train_steps_equal_eager_steps_bitwise(cuda, arch):
    """``train_loop`` on the card (an eager warm-up step, then one captured
    step replayed) against four eager ``make_train_step`` calls on the
    same batches: every loss and grad norm, and the final parameters and
    AdamW state, bit for bit; Mamba layers go through K3 forward and
    backward."""
    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import adamw_init
    cfg = get_reduced_config(arch)
    tcfg = TL.TrainConfig(log_every=1)
    batches = _train_batches(cfg, 4)
    hist = []
    K2.reset_counts()
    K3.reset_counts()
    params, opt, _ = TL.train_loop(cfg, tcfg, iter(batches), 4, device=cuda,
                                   log_fn=lambda s, m: hist.append(m))
    torch.cuda.synchronize()
    mamba = any(m == "mamba" for m, _ in cfg.pattern)
    attn = any(m == "attn" for m, _ in cfg.pattern)
    assert (K3.BWD_LAUNCHES > 0) == mamba and (K3.LAUNCHES > 0) == mamba
    assert (K2.BWD_LAUNCHES > 0) == attn and (K2.LAUNCHES > 0) == attn
    p = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                       cuda)
    o = adamw_init(p, tcfg.optimizer)
    step = TL.make_train_step(cfg, tcfg)
    want = []
    for b in batches:
        p, o, m = step(p, o, TL.batch_to_device(b, cuda))
        want.append({k: float(v) for k, v in m.items()})
    for got, w in zip(hist, want):
        assert got["loss"] == w["loss"] and got["grad_norm"] == w["grad_norm"]
    assert int(opt["step"]) == 4
    for a, b in zip(_bits((params, opt)), _bits((p, o))):
        assert torch.equal(a, b)


def test_train_capture_that_meets_a_host_sync_raises(cuda, monkeypatch):
    """A train step that reads a value back to the host cannot be
    captured: ``train_loop`` raises after the warm-up step, and no eager
    step takes the graph's place."""
    _capture_meets_a_host_sync(cuda, monkeypatch, None)


def _capture_meets_a_host_sync(cuda, monkeypatch, mesh):
    from repro_torch.train import loop as TL
    inner = TL.make_train_step

    def syncing(cfg, tcfg, mesh=None):
        step = inner(cfg, tcfg, mesh)

        def run(params, opt_state, batch):
            out = step(params, opt_state, batch)
            float(out[2]["loss"])                  # a host read-back
            return out

        def in_place(params, opt_state, batch):
            metrics = step.in_place(params, opt_state, batch)
            float(metrics["loss"])                 # a host read-back
            return metrics
        run.in_place = in_place
        return run

    monkeypatch.setattr(TL, "make_train_step", syncing)
    cfg = get_reduced_config("yi-6b")
    with pytest.raises(RuntimeError):
        TL.train_loop(cfg, TL.TrainConfig(), iter(_train_batches(cfg, 3)),
                      3, device=cuda, mesh=mesh)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the multi-device layer at mesh size 1 on the card (NCCL, one rank):
# chip_smoke.py phases 22-24 at reduced size
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh(cuda):
    """A 1 x 1 (data, model) mesh over a one-rank NCCL group (started by
    the first test that asks, kept for the session)."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((1, 1), ("data", "model"))


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-1.3b",
                                  "deepseek-v3-671b"])
def test_mesh_train_step_on_card_matches_no_mesh(cuda, mesh, arch):
    """One float32 train step on DTensors at mesh size 1 against the
    no-mesh step on the card: loss at rtol 1e-5, both AdamW moments at
    relative L2 1e-4 per tensor, and each parameter's update at relative
    L2 1e-2 (as on the CPU meshes: a gradient at AdamW's eps turns a last
    bit into another step; a skipped, halved or reversed update reads 0.5
    or more)."""
    import dataclasses

    import torch.utils._pytree as pytree

    from repro_torch.train.loop import (TrainConfig, make_train_step,
                                        place_state)
    from repro_torch.train.optimizer import adamw_init
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32)
    tcfg = TrainConfig()
    p = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                       cuda)
    o = adamw_init(p, tcfg.optimizer)
    tok = torch.randint(0, cfg.vocab, (4, 32), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    want_p, want_o, want = make_train_step(cfg, tcfg)(p, o, batch)
    pd, od = place_state(cfg, p, o, mesh)
    got_p, got_o, got = make_train_step(cfg, tcfg, mesh)(pd, od, batch)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                               rel=1e-5)

    def rel(a, b):
        return float((_full(a) - b).norm() / b.norm().clamp(min=1e-30))
    for k in ("m", "v"):
        for a, b in zip(pytree.tree_leaves(got_o[k]),
                        pytree.tree_leaves(want_o[k])):
            assert rel(a, b) < 1e-4, k
    for a, b, p0 in zip(pytree.tree_leaves(got_p),
                        pytree.tree_leaves(want_p), pytree.tree_leaves(p)):
        assert rel(_full(a) - p0, b - p0) < 1e-2


@pytest.mark.parametrize("arch,kernel", [("yi-6b", K2), ("mamba2-1.3b", K3)])
def test_mesh_prefill_on_card_goes_through_the_kernels(cuda, mesh, arch,
                                                       kernel):
    """A reduced prefill under serve placements at mesh size 1: one
    kernel launch per layer, on local shards through ``ops.per_rank``,
    logits and a decode step as without the mesh."""
    from repro_torch.launch.shardings import distribute, param_shardings
    cfg = get_reduced_config(arch)
    p = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                       cuda)
    tok = torch.randint(0, cfg.vocab, (2, 64), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(2))
    with torch.no_grad():
        want, caches, n = TT.prefill(p, cfg, tok, max_len=72)
        want_dec, _ = TT.decode_step(p, cfg, want.argmax(-1), caches, n)
        pd = distribute(p, mesh, param_shardings(p, mesh, "serve", cfg))
        kernel.reset_counts()
        got, caches, n = TT.prefill(pd, cfg, tok, max_len=72)
        torch.cuda.synchronize()
        assert kernel.LAUNCHES == cfg.n_layers
        got_dec, _ = TT.decode_step(pd, cfg, want.argmax(-1), caches, n)
    torch.testing.assert_close(_full(got), want, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(_full(got_dec), want_dec, atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("mode", ["train", "serve"])
def test_moe_apply_ep_on_card_matches_moe_apply(cuda, mesh, mode):
    """``repro``'s multi-device MoE case on the card at mesh size 1, at
    its tolerances (atol 2e-5, rtol 1e-4; aux within 15%)."""
    from repro_torch.launch.shardings import distribute, param_shardings
    from repro_torch.models.moe import (MoEConfig, make_moe_params,
                                        moe_apply, moe_apply_ep)
    cfg = MoEConfig(d_model=32, n_experts=8, top_k=2, d_ff_expert=16,
                    capacity_factor=8.0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = make_moe_params(gen, cfg, torch.float32)
    x = torch.randn((4, 8, 32), generator=gen, device=cuda)
    want, aux_want = moe_apply(p, cfg, x)
    placed = distribute({"mlp": p}, mesh,
                        param_shardings({"mlp": p}, mesh, mode))["mlp"]
    y, aux = moe_apply_ep(placed, cfg, x, mesh, ("data",), mode)
    torch.testing.assert_close(_full(y), want, atol=2e-5, rtol=1e-4)
    assert abs(float(_full(aux)) - float(aux_want)) < \
        0.15 * float(aux_want) + 1e-3


def test_compressed_all_reduce_and_checkpoint_on_card(cuda, mesh, tmp_path):
    """The int8 all-reduce over NCCL on a 1 x 1 x 1 (pod, data, model)
    mesh (each element within half its block's scale plus the bf16
    payload's rounding), and a checkpoint of placed state restored into
    its placements, bitwise."""
    import torch.utils._pytree as pytree

    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.compression import (compressed_all_reduce,
                                                     quantize_int8)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.loop import TrainConfig, place_state
    from repro_torch.train.optimizer import adamw_init
    mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"))
    x = torch.randn(5000, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    got = compressed_all_reduce(x, mesh3.get_group("pod"))
    q, scale = quantize_int8(x)
    deq = (q.float() * scale).reshape(-1)[:x.numel()]
    per = scale.repeat_interleave(256)[:x.numel()]
    assert bool(((deq - x).abs() <= per / 2).all())
    assert bool(((got - x).abs() <= per / 2 + deq.abs() * (2.0 ** -7 + 2.0 ** -16)).all())

    cfg = get_reduced_config("yi-6b")
    p = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                       cuda)
    state = place_state(cfg, p, adamw_init(p, TrainConfig().optimizer),
                        mesh)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 1, blocking=True)
    back = mgr.restore(pytree.tree_map(torch.zeros_like, state), 1)
    for a, b in zip(pytree.tree_leaves(back), pytree.tree_leaves(state)):
        assert a.placements == b.placements
        assert torch.equal(a.to_local(), b.to_local())


# ---------------------------------------------------------------------------
# K5: the AdamW update against its plain version
# ---------------------------------------------------------------------------

_F32, _BF16 = torch.float32, torch.bfloat16
K5_COMBOS = [(p, g, m) for p in (_F32, _BF16) for g in (_F32, _BF16)
             for m in (_F32, _BF16)]
# ragged against the 8-element vectors and the 32768-element chunks
K5_SIZES = (1, 7, 8, 33, 1000, 32768, 32769, 100003)
K5_HYPER = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                grad_clip=1.0)


def _combo_id(combo):
    return "-".join({_F32: "f32", _BF16: "bf16"}[d] for d in combo)


def _k5_inputs(cuda, combo, seed, grad_scale, offset=False):
    """(grads, params, ms, vs, step, decays) over ``K5_SIZES``; decay on
    every other tensor.  With ``offset``, tensor ``i``'s parameter,
    gradient and moments start 0, 1 or 2 elements into their storage (in
    turn, so their alignments differ): a bf16 view at a 2-byte offset."""
    p_dt, g_dt, m_dt = combo
    rng = np.random.default_rng(seed)

    def draw(n, dtype, off, f=lambda a: a):
        a = np.asarray(f(rng.normal(size=n + off).astype(np.float32)),
                       np.float32)
        return torch.from_numpy(a).to(dtype).to(cuda)[off:]

    out = ([], [], [], [])
    for i, n in enumerate(K5_SIZES):
        offs = [(i + k) % 3 if offset else 0 for k in range(4)]
        out[0].append(draw(n, g_dt, offs[0], lambda a: grad_scale * a))
        out[1].append(draw(n, p_dt, offs[1]))
        out[2].append(draw(n, m_dt, offs[2], lambda a: 0.1 * a))
        out[3].append(draw(n, m_dt, offs[3], lambda a: 0.01 * np.abs(a)))
    step = torch.tensor(3, dtype=torch.int32, device=cuda)
    return (*out, step, [i % 2 == 0 for i in range(len(K5_SIZES))])


def _copies(ts):
    """Copies at the same storage offsets (clone would realign)."""
    out = []
    for t in ts:
        base = torch.empty(t.storage_offset() + t.numel(), dtype=t.dtype,
                           device=t.device)
        view = base[t.storage_offset():]
        view.copy_(t)
        out.append(view)
    return out


def _k5_state(inputs):
    g, p, m, v, step, decays = inputs
    return g, _copies(p), _copies(m), _copies(v), step.clone(), decays


def _ulps(a, b):
    """Largest distance in units in the last place of ``a``'s dtype."""
    it = torch.int32 if a.dtype == _F32 else torch.int16
    return int((a.view(it).long() - b.view(it).long()).abs().max())


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("combo", K5_COMBOS, ids=_combo_id)
def test_adamw_kernel_matches_plain_bitwise_under_the_clip(cuda, combo,
                                                           offset):
    """The norm under ``grad_clip`` makes both scales exactly 1: every
    parameter, moment and the step bit for bit, decay on and off, ragged
    and misaligned sizes; the norm within 1e-6."""
    inputs = _k5_inputs(cuda, combo, 0, 1e-3, offset)
    g, p, m, v, step, d = _k5_state(inputs)
    want = K5.adamw_step_plain_(g, p, m, v, step, d, **K5_HYPER)
    g2, p2, m2, v2, step2, _ = _k5_state(inputs)
    launches = K5.LAUNCHES
    got = K5.adamw_step_(g2, p2, m2, v2, step2, d, **K5_HYPER)
    torch.cuda.synchronize()
    assert K5.LAUNCHES == launches + 3
    assert float(want) < 1.0
    assert abs(float(got) / float(want) - 1) <= 1e-6
    assert int(step2) == int(step) == 4
    for a, b in zip(p2 + m2 + v2, p + m + v):
        assert _ulps(a, b) == 0


@pytest.mark.parametrize("combo", K5_COMBOS, ids=_combo_id)
def test_adamw_kernel_clipped_within_limits(cuda, combo):
    """With clipping the kernel's norm sums in another order, so its clip
    scale may differ from the plain version's by an ulp: the norm within
    1e-6 relative, the moments and the parameters within relative L2 1e-6
    of the plain version's.  Fed the kernel's own norm, the plain per-tensor
    formula gives the kernel's parameters and moments bit for bit.  (An
    ulp of the scale moves a parameter by a few ulps of its larger operand
    where the step nearly cancels it, and by many more of the result, so
    the limit on parameters is the L2 one.)"""
    inputs = _k5_inputs(cuda, combo, 1, 1e-1, offset=True)
    g, p, m, v, step, d = _k5_state(inputs)
    want = K5.adamw_step_plain_(g, p, m, v, step, d, **K5_HYPER)
    g2, p2, m2, v2, step2, _ = _k5_state(inputs)
    got = K5.adamw_step_(g2, p2, m2, v2, step2, d, **K5_HYPER)
    torch.cuda.synchronize()
    assert float(want) > 10.0
    assert abs(float(got) / float(want) - 1) <= 1e-6
    for a, b in ((p2, p), (m2, m), (v2, v)):
        num = sum(float((x.double() - y.double()).norm()) ** 2
                  for x, y in zip(a, b))
        den = sum(float(y.double().norm()) ** 2 for y in b)
        assert (num / den) ** 0.5 <= 1e-6
    _, p0, m0, v0, step0, _ = _k5_state(inputs)
    scale = K5.clip_scale(got, K5_HYPER["grad_clip"])
    _, c1, c2 = K5.bias_corrections(step0, K5_HYPER["b1"], K5_HYPER["b2"])
    hyper = {k: x for k, x in K5_HYPER.items() if k != "grad_clip"}
    for i in range(len(K5_SIZES)):
        new = K5.update_tensor(g[i], m0[i], v0[i], p0[i], d[i], scale, c1,
                               c2, **hyper)
        for a, b in zip(new, (p2[i], m2[i], v2[i])):
            assert _ulps(a, b) == 0


def test_adamw_kernel_repeatable_and_in_place_equals_out_of_place(cuda):
    """Two in-place calls from the same state give the same bits, and so
    does an out-of-place call, which leaves its inputs as they were."""
    combo = (_BF16, _BF16, _F32)
    inputs = _k5_inputs(cuda, combo, 2, 1e-1)
    runs = []
    for _ in range(2):
        g, p, m, v, step, d = _k5_state(inputs)
        runs.append((K5.adamw_step_(g, p, m, v, step, d, **K5_HYPER),
                     p + m + v + [step]))
    g, p, m, v, step, d = _k5_state(inputs)
    before = [t.clone() for t in p + m + v + [step]]
    out = ([torch.empty_like(t) for t in p], [torch.empty_like(t) for t in m],
           [torch.empty_like(t) for t in v], torch.empty_like(step))
    gnorm = K5.adamw_step_(g, p, m, v, step, d, out=out, **K5_HYPER)
    torch.cuda.synchronize()
    for a, b in zip(p + m + v + [step], before):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][0],
                                                               gnorm)
    for a, b, c in zip(runs[0][1], runs[1][1],
                       out[0] + out[1] + out[2] + [out[3]]):
        assert _ulps(a, b) == 0 if a.dim() else torch.equal(a, b)
        assert _ulps(a, c) == 0 if a.dim() else torch.equal(a, c)


@pytest.mark.parametrize("bad", ["nan_grad", "inf_loss"])
def test_adamw_kernel_skips_a_non_finite_step(cuda, bad):
    """A NaN gradient or an infinite loss: in place nothing is written and
    ``step`` stays; out of place the outputs equal the inputs."""
    inputs = _k5_inputs(cuda, (_BF16, _BF16, _F32), 3, 1e-3)
    g, p, m, v, step, d = _k5_state(inputs)
    loss = torch.tensor(float("inf") if bad == "inf_loss" else 1.0,
                        device=cuda)
    if bad == "nan_grad":
        g = [t.clone() for t in g]
        g[6][77] = float("nan")
    before = [t.clone() for t in p + m + v + [step]]
    gnorm = K5.adamw_step_(g, p, m, v, step, d, loss=loss, **K5_HYPER)
    out = ([torch.empty_like(t) for t in p], [torch.empty_like(t) for t in m],
           [torch.empty_like(t) for t in v], torch.empty_like(step))
    K5.adamw_step_(g, p, m, v, step, d, loss=loss, out=out, **K5_HYPER)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(gnorm)) == (bad == "inf_loss")
    for a, o, b in zip(p + m + v + [step], out[0] + out[1] + out[2] +
                       [out[3]], before):
        assert torch.equal(a, b) and torch.equal(o, b)


def test_adamw_kernel_graph_replays_equal_eager_calls(cuda):
    """K5 captured in a CUDA graph (after an eager call that builds its
    table): three replays take the same steps, bit for bit, as three more
    eager calls on a copy of the state; the capture copies nothing from
    the host."""
    inputs = _k5_inputs(cuda, (_BF16, _F32, _BF16), 4, 1e-1)
    runs = []
    for graphed in (True, False):
        g, p, m, v, step, d = _k5_state(inputs)
        K5.adamw_step_(g, p, m, v, step, d, **K5_HYPER)
        if graphed:
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                norm = K5.adamw_step_(g, p, m, v, step, d, **K5_HYPER)
            norms = []
            for _ in range(3):
                graph.replay()
                norms.append(norm.clone())
        else:
            norms = [K5.adamw_step_(g, p, m, v, step, d, **K5_HYPER)
                     for _ in range(3)]
        torch.cuda.synchronize()
        runs.append((norms, p + m + v + [step]))
    assert int(runs[0][1][-1]) == int(runs[1][1][-1]) == 7
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b)


def test_adamw_update_in_place_holds_no_second_copy(cuda):
    """One ``adamw_update_`` call on a reduced model's state allocates no
    more than K5's scratch (the norm's slots, its results, the bias
    corrections' 0-d tensors); the functional ``adamw_update`` allocates
    at least the parameters and moments again."""
    import torch.utils._pytree as pytree

    from repro_torch.train import optimizer as TO
    cfg = get_reduced_config("yi-6b")
    ocfg = TO.AdamWConfig()
    params = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            cuda)
    state = TO.adamw_init(params, ocfg)
    gen = torch.Generator(device=cuda).manual_seed(1)
    grads = pytree.tree_map(lambda p: 1e-3 * torch.randn(
        p.shape, generator=gen, device=cuda).to(p.dtype), params)
    loss = torch.tensor(1.0, device=cuda)
    TO.adamw_update_(grads, state, params, ocfg, loss=loss)  # its table
    leaves = pytree.tree_leaves(params)
    decays = [TO._decays(k, x)
              for k, x in pytree.tree_flatten_with_path(params)[0]]
    table = K5.table_for(pytree.tree_leaves(grads), leaves,
                         pytree.tree_leaves(state["m"]),
                         pytree.tree_leaves(state["v"]), decays)
    state_bytes = sum(t.numel() * t.element_size() for t in
                      pytree.tree_leaves((params, state["m"], state["v"])))
    extra = {}
    for form in ("in_place", "functional"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if form == "in_place":
            out = TO.adamw_update_(grads, state, params, ocfg, loss=loss)
        else:
            out = TO.adamw_update(grads, state, params, ocfg, loss=loss)
        torch.cuda.synchronize()
        extra[form] = torch.cuda.max_memory_allocated() - before
        del out
    assert extra["in_place"] <= K5.scratch_bytes(table)
    assert extra["functional"] >= state_bytes


def test_adamw_kernel_refuses_inputs_it_does_not_take(cuda, mesh):
    """DTensors given to the kernel's wrapper itself (the optimizer hands
    it their local shards), a ``Partial`` gradient given to the
    optimizer, float16, a strided tensor and mixed devices raise; no call
    falls back to the plain version or launches."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          distribute_tensor)

    from repro_torch.train import optimizer as TO
    g, p, m, v, step, d = _k5_state(_k5_inputs(cuda, (_F32,) * 3, 5, 1e-3))
    launches = K5.LAUNCHES
    dt = [distribute_tensor(t.clone(), mesh, [Replicate(), Replicate()])
          for t in p[:2]]
    with pytest.raises(TypeError):
        K5.adamw_step_(dt, dt, dt, dt, step, d[:2], **K5_HYPER)
    partial = DTensor.from_local(g[0].clone(), mesh, [Partial(), Partial()])
    rep = [Replicate(), Replicate()]
    with pytest.raises(ValueError):
        TO.adamw_update_({"a": partial}, {
            "m": {"a": dt[0]}, "v": {"a": dt[1]},
            "step": distribute_tensor(step.clone(), mesh, rep)}, {"a": dt[0]},
            TO.AdamWConfig())
    half = [t.half() for t in p]
    with pytest.raises(TypeError):
        K5.adamw_step_(half, half, m, v, step, d, **K5_HYPER)
    strided = [torch.zeros(2 * t.numel(), device=cuda)[::2] for t in p]
    with pytest.raises(ValueError):
        K5.adamw_step_(g, strided, m, v, step, d, **K5_HYPER)
    with pytest.raises(ValueError):
        K5.adamw_step_([t.cpu() for t in g], p, m, v, step, d, **K5_HYPER)
    torch.cuda.synchronize()
    assert K5.LAUNCHES == launches


def test_train_program_on_card_runs_k5_and_no_copy_back(cuda):
    """``train_loop`` on the card: the warm-up and the capture each call
    K5 once (three CUDA kernels); a profiled replay runs K5's three
    kernels once each and calls no wrapper."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import adamw_init
    cfg = get_reduced_config("yi-6b")
    tcfg = TL.TrainConfig()
    batches = _train_batches(cfg, 1)
    params = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            cuda)
    opt = adamw_init(params, tcfg.optimizer)
    batch = TL.batch_to_device(batches[0], cuda)
    program = TL.TrainProgram(TL.make_train_step(cfg, tcfg), params, opt,
                              batch)
    K5.reset_counts()
    program.step(batch)
    assert K5.LAUNCHES == 6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        program.step(batch)
        torch.cuda.synchronize()
    names = {e.key: e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA}
    for k in ("adamw_norm", "adamw_finish", "adamw_apply"):
        assert sum(c for n, c in names.items() if k in n) == 1, names
    assert K5.LAUNCHES == 6
    assert int(opt["step"]) == 2


def test_train_program_keeps_its_k5_table_past_the_cache(cuda):
    """A captured ``TrainProgram`` keeps the K5 table its graph reads by
    pointer: after more in-place sets than K5's table cache holds have
    gone through ``adamw_update_`` (the program's table dropped from the
    cache) and new tensors have taken the freed memory, a replay still
    equals an eager in-place step on a copy of the state, bit for bit."""
    import torch.utils._pytree as pytree

    from repro_torch.train import loop as TL
    from repro_torch.train import optimizer as TO
    cfg = get_reduced_config("yi-6b")
    tcfg = TL.TrainConfig()
    batches = [TL.batch_to_device(b, cuda) for b in _train_batches(cfg, 2)]
    params = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            cuda)
    opt = TO.adamw_init(params, tcfg.optimizer)
    step = TL.make_train_step(cfg, tcfg)
    program = TL.TrainProgram(step, params, opt, batches[0])
    program.step(batches[0])                  # warm-up and capture
    assert len(program.tables) == 1
    held = program.tables[0]
    p, o = (pytree.tree_map(torch.clone, x) for x in (params, opt))
    want = {k: float(v) for k, v in step.in_place(p, o, batches[1]).items()}
    for i in range(K5._TABLE_CACHE + 1):
        w = {"w": torch.randn(100 + i, device=cuda)}
        TO.adamw_update_({"w": torch.randn(100 + i, device=cuda)},
                         TO.adamw_init(w, tcfg.optimizer), w,
                         tcfg.optimizer)
    assert all(t is not held for t in K5._TABLES.values())
    junk = [torch.full_like(held.tab, -1) for _ in range(64)]
    got = {k: float(v) for k, v in program.step(batches[1]).items()}
    torch.cuda.synchronize()
    del junk
    assert program.replays == 1 and got == want
    for a, b in zip(_bits((params, opt)), _bits((p, o))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K5 on a mesh: local shards, the norm's total all-reduced between passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_scale", [1e-4, 1e-1],
                         ids=["unclipped", "clipped"])
def test_adamw_update_on_dtensors_equals_their_local_tensors(cuda, mesh,
                                                             grad_scale):
    """At mesh size 1, ``adamw_update_`` on DTensors (K5 on the local
    shards: norm, sum, the all-reduce, finish, apply: four kernels) is bit
    for bit ``adamw_update_`` on the same tensors without a mesh (three
    kernels): the norm, parameters, moments and step, clipped or not; so
    is ``adamw_update`` on the DTensors, whose inputs stay as they were."""
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.train import loop as TL
    from repro_torch.train import optimizer as TO
    cfg = get_reduced_config("yi-6b")
    ocfg = TO.AdamWConfig()
    params = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            cuda)
    state = TO.adamw_init(params, ocfg)
    gen = torch.Generator(device=cuda).manual_seed(1)

    def draw(t, scale):
        return (scale * torch.randn(t.shape, generator=gen, device=cuda)
                ).to(t.dtype)
    state["m"] = pytree.tree_map(lambda t: draw(t, 1e-3), state["m"])
    state["v"] = pytree.tree_map(lambda t: draw(t, 1e-3).abs(), state["v"])
    grads = pytree.tree_map(lambda t: draw(t, grad_scale), params)
    loss = torch.tensor(1.0, device=cuda)

    def clone(tree):
        return pytree.tree_map(torch.clone, tree)
    pd, sd = TL.place_state(cfg, clone(params), clone(state), mesh)
    gd = pytree.tree_map(lambda g, p: distribute_tensor(
        g.clone(), mesh, p.placements), grads, pd)
    pf, sf = TL.place_state(cfg, clone(params), clone(state), mesh)
    K5.reset_counts()
    want = TO.adamw_update_(grads, state, params, ocfg, loss=loss)
    torch.cuda.synchronize()
    assert K5.LAUNCHES == 3
    got = TO.adamw_update_(gd, sd, pd, ocfg, loss=loss)
    torch.cuda.synchronize()
    assert K5.LAUNCHES == 3 + 4
    new_p, new_s, got_f = TO.adamw_update(gd, sf, pf, ocfg, loss=loss)
    torch.cuda.synchronize()
    assert (float(want) > ocfg.grad_clip) == (grad_scale > 1e-2)
    assert torch.equal(got, want) and torch.equal(got_f, want)

    def local(tree):
        return [t.to_local() for t in pytree.tree_leaves(tree)]
    for a, b in zip(_bits(local((pd, sd))), _bits((params, state))):
        assert torch.equal(a, b)
    for a, b in zip(_bits(local((new_p, new_s))), _bits((params, state))):
        assert torch.equal(a, b)
    assert int(sf["step"].to_local()) == 0


def test_mesh_train_loop_on_card_equals_no_mesh_bitwise(cuda, mesh):
    """``train_loop(..., mesh=)`` at mesh size 1 (the captured mesh
    program: K5 on the local shards, four kernels a call) against the
    no-mesh loop (the captured program, three a call): every loss and grad
    norm and the final parameters and AdamW state, bit for bit.  Each
    loop calls K5's wrapper twice, in the warm-up and the capture; the
    replays call none."""
    from repro_torch.train import loop as TL
    cfg = get_reduced_config("yi-6b")
    tcfg = TL.TrainConfig(log_every=1)
    batches = _train_batches(cfg, 3)
    runs = {}
    for on in (None, mesh):
        hist = []
        K5.reset_counts()
        p, o, _ = TL.train_loop(cfg, tcfg, iter(batches), 3, device=cuda,
                                mesh=on, log_fn=lambda s, m: hist.append(m))
        torch.cuda.synchronize()
        runs[on is None] = (hist, K5.LAUNCHES, p, o)
    (plain, n_plain, p0, o0), (meshed, n_mesh, p1, o1) = runs[True], \
        runs[False]
    assert n_plain == 6 and n_mesh == 8       # warm-up + capture
    for a, b in zip(meshed, plain):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    import torch.utils._pytree as pytree
    local = [t.to_local() for t in pytree.tree_leaves((p1, o1))]
    for a, b in zip(_bits(local), _bits((p0, o0))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-1.3b"])
def test_mesh_program_replays_equal_eager_mesh_steps_bitwise(cuda, mesh,
                                                             arch):
    """A ``TrainProgram`` on the 1 x 1 NCCL mesh (the sharded init, an
    eager warm-up, then one captured step replayed: DTensor's
    redistributions, K5's four kernels and the norm's all-reduce in the
    graph) against eager ``step_fn.in_place`` mesh steps from the same
    init on the same batches: every loss and grad norm and the final
    shards bit for bit; Mamba layers run K3 forward and backward."""
    import torch.utils._pytree as pytree

    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import adamw_init
    cfg = get_reduced_config(arch)
    tcfg = TL.TrainConfig()
    step = TL.make_train_step(cfg, tcfg, mesh)
    batches = [TL.batch_to_device(b, cuda) for b in _train_batches(cfg, 4)]

    def state():
        p = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           cuda, mesh=mesh)
        return p, adamw_init(p, tcfg.optimizer)
    (pa, oa), (pb, ob) = state(), state()
    program = TL.TrainProgram(step, pa, oa, batches[0])
    K3.reset_counts()
    for b in batches:
        got = {k: float(v) for k, v in program.step(b).items()}
        want = {k: float(v) for k, v in step.in_place(pb, ob, b).items()}
        assert got == want
    torch.cuda.synchronize()
    assert program.graph is not None and program.replays == 3
    mamba = any(m == "mamba" for m, _ in cfg.pattern)
    assert (K3.BWD_LAUNCHES > 0) == mamba
    local = [[t.to_local() for t in pytree.tree_leaves(x)]
             for x in ((pa, oa), (pb, ob))]
    for a, b in zip(_bits(local[0]), _bits(local[1])):
        assert torch.equal(a, b)


def test_train_program_refuses_a_gloo_mesh_on_the_card(cuda, mesh):
    """A mesh of CUDA tensors over a gloo group (as in ``chip_smoke.py``
    phase 9d) cannot be captured: ``TrainProgram`` and ``train_loop``
    raise, saying why, and take no eager step instead."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import adamw_init
    group = dist.new_group(ranks=[0], backend="gloo")
    gloo = DeviceMesh.from_group([group, group], "cuda", mesh=[[0]],
                                 mesh_dim_names=("data", "model"))
    cfg = get_reduced_config("yi-6b")
    tcfg = TL.TrainConfig()
    batches = _train_batches(cfg, 2)
    params = TT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            cuda, mesh=gloo)
    opt = adamw_init(params, tcfg.optimizer)
    K5.reset_counts()
    with pytest.raises(ValueError, match="gloo"):
        TL.TrainProgram(TL.make_train_step(cfg, tcfg, gloo), params, opt,
                        TL.batch_to_device(batches[0], cuda))
    with pytest.raises(ValueError, match="gloo"):
        TL.train_loop(cfg, tcfg, iter(batches), 2, device=cuda, mesh=gloo)
    assert K5.LAUNCHES == 0


def test_mesh_train_capture_that_meets_a_host_sync_raises(cuda, mesh,
                                                          monkeypatch):
    """On the 1 x 1 NCCL mesh too, a step that reads a value back to the
    host cannot be captured, and ``train_loop`` raises."""
    _capture_meets_a_host_sync(cuda, monkeypatch, mesh)
