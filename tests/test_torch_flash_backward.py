"""K2's backward on the CPU: ``flash_attention_backward_plain`` (the oracle
the backward kernel is held against on the card) against ``jax.vjp`` of
the JAX package's ``dense_attention``, and of ``attention_any``'s chunked
path where S is past ``dense_threshold``; the plain forward's log-sum-exp;
the ``FlashAttention`` autograd Function through the plain versions
(``gradcheck`` in float64, meta tensors); ``backward_route``; and that the
models' CPU path stays ``attention_any``.

Inputs are made with NumPy from a seed and handed to both packages.
Tolerances, relative L2 per gradient (the RMS error where the reference
gradient is exactly zero): float32 1e-5 (the same float32 algebra summed
in other orders); bfloat16 inputs 2e-2 against the float32 reference on
the same rounded values (the gradients come back in bfloat16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

# b, s, hq, hkv, d, window: every batch, length, head grouping, head dim
# and window of the grid B {1, 2} x S {1, 17, 64, 96} x Hq/Hkv {4/4, 4/2,
# 6/2, 4/1} x D {8, 16, 64} x window {None, 5, 32} appears, and each
# grouping meets each length
CASES = [
    (1, 1, 4, 4, 8, None), (2, 1, 4, 2, 16, 5), (1, 1, 6, 2, 64, 32),
    (2, 1, 4, 1, 8, None),
    (1, 17, 4, 4, 16, 5), (2, 17, 4, 2, 64, None), (1, 17, 6, 2, 8, 32),
    (2, 17, 4, 1, 16, None),
    (1, 64, 4, 4, 64, 32), (2, 64, 4, 2, 8, 5), (1, 64, 6, 2, 16, None),
    (1, 64, 4, 1, 64, 5),
    (2, 96, 4, 4, 8, None), (1, 96, 4, 2, 16, 32), (2, 96, 6, 2, 64, 5),
    (1, 96, 4, 1, 8, 32),
]


def _inputs(seed, b, s, hq, hkv, d, dtype):
    """q, k, v, dO as float32 NumPy arrays already rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(b, s, h, d)).astype(np.float32)
           for h in (hq, hkv, hkv, hq)]
    return [torch.from_numpy(a).to(dtype).float().numpy() for a in out]


def _jax_grads(fn, arrays):
    q, k, v, do = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(fn, q, k, v)
    return [np.asarray(g) for g in vjp(do)]


def _plain_grads(arrays, dtype, window):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    o, lse = K2.flash_attention_plain(q, k, v, window=window, return_lse=True)
    return K2.flash_attention_backward_plain(q, k, v, o, lse, do,
                                             window=window)


def _rel_l2(got, want) -> float:
    """Relative L2 error; against a gradient that is exactly zero (dq and
    dk at S = 1, where each row's softmax is the constant 1) the error's
    RMS, the inputs being of unit scale."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want) or np.sqrt(want.size)
    return float(np.linalg.norm(got - want) / den)


def _check(got, want, dtype):
    for name, g, w, in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and tuple(g.shape) == w.shape, name
        err = _rel_l2(g.float().numpy(), w)
        assert err <= TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,window", CASES)
def test_plain_backward_matches_jax_vjp_of_dense_attention(b, s, hq, hkv, d,
                                                           window, dtype):
    arrays = _inputs(b * 1000 + s * 10 + d, b, s, hq, hkv, d, dtype)
    want = _jax_grads(lambda q, k, v: jattn.dense_attention(
        q, k, v, causal=True, window=window), arrays)
    _check(_plain_grads(arrays, dtype, window), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,window,chunk", [
    (1, 64, 4, 2, 16, None, 32), (2, 96, 6, 2, 8, 5, 32),
    (1, 96, 4, 1, 64, 32, 16), (2, 64, 4, 4, 8, 32, 16)])
def test_plain_backward_matches_jax_vjp_of_the_chunked_path(
        b, s, hq, hkv, d, window, chunk, dtype):
    """Past ``dense_threshold`` ``attention_any`` takes the chunked
    online-softmax path; its gradient is the same function's."""
    arrays = _inputs(s + d + chunk, b, s, hq, hkv, d, dtype)
    want = _jax_grads(lambda q, k, v: jattn.attention_any(
        q, k, v, causal=True, window=window, chunk_size=chunk,
        dense_threshold=chunk), arrays)
    _check(_plain_grads(arrays, dtype, window), want, dtype)


@pytest.mark.parametrize("b,s,hq,hkv,d,window", CASES[::3])
def test_plain_lse_is_the_logsumexp_of_the_masked_logits(b, s, hq, hkv, d,
                                                         window):
    q, k, v, _ = _inputs(s * 7 + d, b, s, hq, hkv, d, torch.float32)
    g = hq // hkv
    logits = jnp.einsum("bskgd,btkd->bkgst", q.reshape(b, s, hkv, g, d),
                        k) / np.sqrt(d)
    pos = jnp.arange(s)
    live = pos[:, None] >= pos[None, :]
    if window is not None:
        live &= pos[:, None] - pos[None, :] < window
    want = jax.nn.logsumexp(jnp.where(live, logits, -jnp.inf), axis=-1)
    _, lse = K2.flash_attention_plain(*(torch.from_numpy(a)
                                        for a in (q, k, v)),
                                      window=window, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, s)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want).reshape(b, hq, s),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("b,s,hq,hkv,d,window", [
    (1, 5, 4, 2, 3, None), (2, 7, 6, 2, 4, 3), (1, 6, 4, 1, 5, 2),
    (1, 1, 2, 2, 2, None)])
def test_flash_attention_function_passes_gradcheck(b, s, hq, hkv, d,
                                                   window):
    """``FlashAttention`` on the CPU (the plain forward with its
    log-sum-exp, then the plain backward) in float64, against finite
    differences."""
    gen = torch.Generator().manual_seed(s * 10 + d)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, dtype=torch.float64,
                           requires_grad=True) for h in (hq, hkv, hkv))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.FlashAttention.apply(q, k, v, True, window,
                                                 None), (q, k, v))


def test_flash_attention_function_with_a_scale_and_no_cotangent():
    """A given scale reaches both directions; an unused output counts as a
    zero cotangent."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 9, h, 4), generator=gen, dtype=torch.float64,
                           requires_grad=True) for h in (4, 2, 2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.FlashAttention.apply(q, k, v, True, 4, 0.3),
        (q, k, v))
    out = ops.FlashAttention.apply(q, k, v, True, None, None)
    (other,) = torch.autograd.grad(out.sum() * 0 + q.sum(), q)
    assert torch.equal(other, torch.ones_like(q))


def test_meta_tensors_give_the_gradients_shapes():
    q = torch.empty((2, 8, 6, 16), device="meta", requires_grad=True)
    k = torch.empty((2, 8, 2, 16), device="meta", requires_grad=True)
    v = torch.empty((2, 8, 2, 16), device="meta", requires_grad=True)
    out = ops.FlashAttention.apply(q, k, v, True, 3, None)
    grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert all(g.device.type == "meta" for g in grads)
    o, lse = K2.flash_attention(q.detach(), k.detach(), v.detach(),
                                return_lse=True)
    dq, dk, dv = K2.flash_attention_backward(q, k, v, o, lse, o)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert lse.shape == (2, 6, 8) and lse.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_route_for_every_head_dim(dtype):
    """bfloat16 takes ``wgmma`` at its head dims (yi-6b's and
    gemma3-27b's 128, musicgen-large's 64), ``mma`` at 160 and 256, and
    the generic route elsewhere; float32 always the generic one."""
    for d in range(1, K2.MAX_HEAD_DIM + 1):
        want = "generic"
        if dtype == torch.bfloat16 and d in K2.BWD_WGMMA_HEAD_DIMS:
            want = "wgmma"
        elif dtype == torch.bfloat16 and d in K2.BWD_MMA_HEAD_DIMS:
            want = "mma"
        assert K2.backward_route(d, dtype) == want, d
    if dtype == torch.bfloat16:
        assert [K2.backward_route(d, dtype) for d in (64, 128, 160, 256)] \
            == ["wgmma", "wgmma", "mma", "mma"]
    for d in (0, K2.MAX_HEAD_DIM + 1):
        with pytest.raises(ValueError, match="head dim"):
            K2.backward_route(d, dtype)


def test_backward_route_refuses_other_types():
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            K2.backward_route(128, dtype)


@pytest.mark.parametrize("route,macro", [
    ("mma", "FLASH_BWD_MMA_D32_MASK"),
    ("wgmma", "FLASH_BWD_WGMMA_D32_MASK")])
def test_backward_head_dims_build_mask(route, macro):
    """Each tensor-core route's head dims reach the source as bit D / 32 - 1
    of its own mask, as the forward's fast head dims do; the launcher
    takes the route at exactly those D, and no D is on both routes."""
    dims = {"mma": K2.BWD_MMA_HEAD_DIMS,
            "wgmma": K2.BWD_WGMMA_HEAD_DIMS}[route]
    flags = dict(f[2:].split("=") for f in K2.BWD_NVCC_FLAGS)
    assert sorted(flags) == ["FLASH_BWD_MMA_D32_MASK",
                             "FLASH_BWD_WGMMA_D32_MASK"]
    mask = int(flags[macro].rstrip("u"), 16)
    assert [32 * (i + 1) for i in range(8) if mask >> i & 1] == sorted(dims)
    assert all(d % 32 == 0 for d in dims)
    assert not set(K2.BWD_MMA_HEAD_DIMS) & set(K2.BWD_WGMMA_HEAD_DIMS)
    assert K2.BWD_ROUTES.index(route) == {"mma": 0, "wgmma": 2}[route]


def test_the_models_cpu_path_stays_attention_any(monkeypatch):
    """``gqa_forward`` on the CPU under autograd runs ``attention_any``, as
    the JAX package's train step differentiates it: the kernels' autograd
    Function is not reached, and the output is ``attention_any``'s bit for
    bit."""
    def refuse(*args):
        raise AssertionError("FlashAttention reached on the CPU")

    monkeypatch.setattr(ops.FlashAttention, "apply", refuse)
    cfg = tattn.AttentionConfig(d_model=32, n_heads=4, n_kv_heads=2,
                                head_dim=8, window=5)
    gen = torch.Generator().manual_seed(0)
    params = tattn.make_attention_params(gen, cfg, torch.float32)
    x = torch.randn((2, 12, 32), generator=gen, requires_grad=True)
    pos = torch.arange(12)
    out = tattn.gqa_forward(params, cfg, x, pos)
    q, k, v = tattn._qkv(params, cfg, x, pos)
    want = tattn.attention_any(q, k, v, window=5) \
        .reshape(2, 12, -1) @ params["w_o"]
    assert torch.equal(out, want)
    out.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
