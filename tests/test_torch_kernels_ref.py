"""The port's attention and SSD oracles, chunked paths and kernel plain
versions against the JAX package's, on the CPU.

Inputs are made with NumPy from a seed and handed to both packages.
Tolerances: 2e-5 (float32) and 2e-2 (bfloat16) for attention, 1e-3
(float32) and 5e-2 (bfloat16) for the SSD scan, as the JAX package's own
kernel tests (``tests/test_kernels.py``); 1e-5 where both sides run the same
float32 algorithm.  The Pallas kernels run in interpret mode, at one
float32 and one bfloat16 shape each.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import attention as jattn
from repro.models import mamba as jmamba
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as K3
from repro_torch.models import attention as tattn
from repro_torch.models import mamba as tmamba

_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array of ``dtype``."""
    return (jnp.asarray(a).astype(_JNP[dtype]),
            torch.from_numpy(np.ascontiguousarray(a)).to(_TORCH[dtype]))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _qkv(seed, b, s, hq, hkv, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]
    pairs = [_both(a, dtype) for a in arrs]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _ssd_inputs(seed, bt, s, h, p, g, n, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bt, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(bt, s, h)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)) * 0.5)).astype(np.float32)
    B = rng.normal(size=(bt, s, g, n)).astype(np.float32)
    C = rng.normal(size=(bt, s, g, n)).astype(np.float32)
    jx, tx = _both(x, dtype)
    jB, tB = _both(B, dtype)
    jC, tC = _both(C, dtype)
    return ((jx, jnp.asarray(dt), jnp.asarray(A), jB, jC),
            (tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC))


# ---------------------------------------------------------------------------
# oracles and plain paths (float32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 24])
def test_attention_ref_matches_repro(window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(0, 2, 64, 4, 2, 16, "f32")
    want = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    got = tref.attention_ref(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_dense_attention_matches_repro(window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 48, 6, 2, 16, "f32")
    want = jattn.dense_attention(jq, jk, jv, causal=True, window=window)
    got = tattn.dense_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s,window", [(256, None), (256, 80)])
def test_chunked_attention_matches_repro(s, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 1, s, 4, 2, 32, "f32")
    want = jattn.chunked_attention(jq, jk, jv, causal=True, window=window,
                                   chunk_size=64)
    got = tattn.chunked_attention(tq, tk, tv, causal=True, window=window,
                                  chunk_size=64)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    # and the chunked path is the dense one
    dense = tattn.dense_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(dense), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [None, 100])
def test_chunked_attention_in_64_token_chunks_matches_repro(window):
    """S = 9 x 64: no chunk of 512, 256 or 128 divides it, so both
    packages' ``attention_any`` take 64-token chunks (musicgen-large's
    prefill with its prefix is 513 x 64); a window of 100 is no multiple of
    the chunk, so two diagonals need its mask."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(5, 1, 9 * 64, 4, 2, 16, "f32")
    want = jattn.attention_any(jq, jk, jv, window=window,
                               dense_threshold=256)
    got = tattn.attention_any(tq, tk, tv, window=window, dense_threshold=256)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    dense = tattn.dense_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(dense), atol=2e-5, rtol=2e-5)


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ATen ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("window", [None, 100])
def test_chunked_attention_ops_grow_with_the_chunk_count(window):
    """The pairs of one diagonal run as one batch: 16 chunks take at most
    2.5x the ATen ops of 8.  A loop over pairs takes ~3.7x, and ~2.8x with
    the window of 100 (7 chunks of 16 back)."""
    counts = []
    for n in (8, 16):
        _, (tq, tk, tv) = _qkv(6, 1, n * 16, 2, 1, 8, "f32")
        with _OpCount() as mode:
            tattn.chunked_attention(tq, tk, tv, window=window, chunk_size=16)
        counts.append(mode.n)
    assert counts[1] <= 2.5 * counts[0], counts


def test_attention_any_picks_chunked_above_threshold():
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 1, 192, 2, 1, 16, "f32")
    want = jattn.attention_any(jq, jk, jv, chunk_size=128, dense_threshold=64)
    got = tattn.attention_any(tq, tk, tv, chunk_size=128, dense_threshold=64)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_ssd_ref_matches_repro():
    jin, tin = _ssd_inputs(4, 2, 64, 4, 16, 2, 16, "f32")
    jy, js = jref.ssd_ref(*jin)
    ty, ts = tref.ssd_ref(*tin)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_chunked_matches_repro_and_ref(chunk):
    jin, tin = _ssd_inputs(5, 2, 64, 4, 16, 2, 16, "f32")
    jy, js = jmamba.ssd_chunked(*jin, chunk)
    ty, ts = tmamba.ssd_chunked(*tin, chunk)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-5, rtol=1e-5)
    ry, rs = tref.ssd_ref(*tin)
    np.testing.assert_allclose(_np(ty), _np(ry), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_np(ts), _np(rs), atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# kernel plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,hq,hkv,d,window,dtype,tol", [
    (1, 256, 4, 2, 64, 128, "f32", 2e-5),
    (1, 256, 2, 2, 128, None, "bf16", 2e-2),
])
def test_k2_plain_matches_pallas(b, s, hq, hkv, d, window, dtype, tol):
    (jq, jk, jv), (tq, tk, tv) = _qkv(6, b, s, hq, hkv, d, dtype)
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                  interpret=True)
    got = K2.flash_attention_plain(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    # on a CPU tensor the wrapper is the plain version, and counts nothing
    K2.reset_counts()
    assert torch.equal(K2.flash_attention(tq, tk, tv, window=window), got)
    assert K2.LAUNCHES == 0


@pytest.mark.parametrize("bt,s,h,p,g,n,chunk,dtype,tol", [
    (1, 256, 2, 64, 1, 64, 128, "f32", 1e-3),
    (1, 256, 2, 64, 1, 64, 128, "bf16", 5e-2),
])
def test_k3_plain_matches_pallas(bt, s, h, p, g, n, chunk, dtype, tol):
    jin, tin = _ssd_inputs(7, bt, s, h, p, g, n, dtype)
    jy, js = ssd_scan_pallas(*jin, chunk_size=chunk, interpret=True)
    ty, ts = K3.ssd_scan_plain(*tin)
    assert ty.dtype == tin[0].dtype and ts.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(ts), _np(js), atol=tol, rtol=tol)
    K3.reset_counts()
    wy, ws = K3.ssd_scan(*tin)
    assert torch.equal(wy, ty) and torch.equal(ws, ts) and K3.LAUNCHES == 0


def test_k2_plain_takes_ragged_lengths():
    """The kernel takes any S; its plain version is the oracle there."""
    for s in (1, 33):
        _, (tq, tk, tv) = _qkv(8, 1, s, 4, 1, 64, "f32")
        got = K2.flash_attention_plain(tq, tk, tv)
        want = tref.attention_ref(tq, tk, tv)
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_ops_on_cpu_run_the_models_paths():
    _, (tq, tk, tv) = _qkv(9, 1, 128, 4, 2, 16, "f32")
    got = ops.flash_attention(tq, tk, tv, window=40, chunk_size=64,
                              dense_threshold=64)
    want = tattn.attention_any(tq, tk, tv, window=40, chunk_size=64,
                               dense_threshold=64)
    assert torch.equal(got, want)
    _, tin = _ssd_inputs(10, 1, 64, 2, 16, 1, 16, "f32")
    y, state = ops.ssd_scan(*tin, chunk_size=32)
    wy, ws = tmamba.ssd_chunked(*tin, 32)
    assert torch.equal(y, wy) and torch.equal(state, ws)


def test_ops_raise_on_other_devices():
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q, q, q)
    x = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.ssd_scan(x, x[..., 0], x[0, 0, :, 0], x, x)


@pytest.mark.parametrize("case", ["causal", "dtype", "head_dim", "groups",
                                  "contiguous", "head_dim_96",
                                  "head_dim_256"])
def test_k2_rejects_what_the_kernel_does_not_take(case):
    q, k, v = (torch.zeros((1, 8, 4, 64)), torch.zeros((1, 8, 2, 64)),
               torch.zeros((1, 8, 2, 64)))
    causal = True
    if case == "causal":
        causal = False
    elif case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "head_dim":
        # one past the generic route's widest head dim
        q, k, v = (torch.zeros(t.shape[:3] + (K2.MAX_HEAD_DIM + 1,))
                   for t in (q, k, v))
    elif case == "groups":
        q = torch.zeros((1, 8, 3, 64))
    elif case == "contiguous":
        q = torch.zeros((1, 4, 8, 64)).transpose(1, 2)
    elif case.startswith("head_dim_"):
        # 96 and 256 past the generic route's widest head dim (96 and 256
        # themselves take a route: test_k2_takes_every_head_dim_up_to_256)
        d = K2.MAX_HEAD_DIM + int(case.rsplit("_", 1)[1])
        q, k, v = (torch.zeros(t.shape[:3] + (d,)) for t in (q, k, v))
    with pytest.raises((TypeError, ValueError)):
        K2._check(q, k, v, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 12, 32, 96, 256])
def test_k2_takes_every_head_dim_up_to_256(d, dtype):
    """Every head dim up to 256 reaches a route: those outside HEAD_DIMS the
    generic route, paligemma-3b's 256 the fast route of its type."""
    q = torch.zeros((1, 8, 4, d), dtype=dtype)
    k = v = torch.zeros((1, 8, 2, d), dtype=dtype)
    fast = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert K2._check(q, k, v, True) == (fast if d == 256 else "generic")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 160])
def test_k2_takes_head_dims_64_128_160(d, dtype):
    """stablelm-12b's head dim 160 goes to the kernel like 64 and 128."""
    q = torch.zeros((1, 8, 4, d), dtype=dtype)
    k = v = torch.zeros((1, 8, 2, d), dtype=dtype)
    assert K2._check(q, k, v, True) == K2.route(d, dtype)


@pytest.mark.parametrize("case", ["dtype", "dt_dtype", "state_dim", "groups",
                                  "shape"])
def test_k3_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros((1, 8, 4, 64))
    dt = torch.zeros((1, 8, 4))
    A = torch.zeros(4)
    B = C = torch.zeros((1, 8, 2, 64))
    if case == "dtype":
        x = x.half()
    elif case == "dt_dtype":
        dt = dt.double()
    elif case == "state_dim":
        # a state [N, P] past a block's shared memory (N = 32 takes the
        # generic route: test_k3_takes_other_state_dims_generically)
        B = C = torch.zeros((1, 8, 2, 1024))
    elif case == "groups":
        B = C = torch.zeros((1, 8, 3, 64))
    elif case == "shape":
        dt = torch.zeros((1, 9, 4))
    with pytest.raises((TypeError, ValueError)):
        K3._check(x, dt, A, B, C)


@pytest.mark.parametrize("n,p", [(32, 64), (16, 16), (16, 64)])
def test_k3_takes_other_state_dims_generically(n, p):
    x = torch.zeros((1, 8, 4, p))
    dt = torch.zeros((1, 8, 4))
    B = C = torch.zeros((1, 8, 2, n))
    assert K3._check(x, dt, torch.zeros(4), B, C) == "generic"
