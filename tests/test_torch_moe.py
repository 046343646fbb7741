"""The port's MoE layer and MLA attention against the JAX package's, on the
CPU.

``repro``'s parameters (``make_moe_params``, ``make_attention_params``) are
carried across as NumPy arrays; inputs are drawn with NumPy from a seed and
fed to both.

Tolerances: float32 1e-5 (absolute and relative; summation order only).
bfloat16 3e-2 absolute for outputs of magnitude ~1: one bf16 ulp at 1 is
8e-3 and the two frameworks round the expert products and the k-way
combine at different places.  The aux loss is float32 in both (router,
scores and counts), 1e-5 relative.  The dispatch is integer: each slot's
expert, its rank within the expert and whether it fits the capacity are
equal, checked against a rank computed independently in NumPy from
``repro``'s own top-k choice.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as repro_config
from repro.models import attention as JA
from repro.models import moe as JM
from repro_torch.configs import get_reduced_config
from repro_torch.models import attention as TA
from repro_torch.models import moe as TM

TOL = {"f32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=3e-2, rtol=0)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _to_torch(tree, dtype):
    """repro's parameter dict as the port's: float32 routers, ``dtype``
    otherwise (bf16 values cast exactly)."""
    if isinstance(tree, dict):
        return {k: (torch.from_numpy(_np(v)) if k == "router"
                    else _to_torch(v, dtype)) for k, v in tree.items()}
    return torch.from_numpy(_np(tree)).to(dtype)


def _moe_cfgs(arch: str, capacity_factor: float | None):
    jcfg, tcfg = repro_config(arch).moe, get_reduced_config(arch).moe
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    return jcfg, tcfg


def _ranks(flat_e: np.ndarray) -> np.ndarray:
    """Each slot's rank among the earlier slots routed to its expert."""
    seen: dict[int, int] = {}
    out = np.empty(len(flat_e), np.int64)
    for i, e in enumerate(flat_e.tolist()):
        out[i] = seen.get(e, 0)
        seen[e] = out[i] + 1
    return out


# deepseek: sigmoid router + shared expert; arctic: softmax + dense branch
# (shared); jamba: softmax, no shared expert.  Capacity factor 0.5 drops
# slots (cap = 48·2·0.5/E against a mean load of 48·2/E); None keeps the
# reduced configs' 8.0, where nothing drops.
MOE_ARCHS = ["deepseek-v3-671b", "arctic-480b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cf", [0.5, None], ids=["dropping", "roomy"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_repro(arch, cf, dtype):
    jcfg, tcfg = _moe_cfgs(arch, cf)
    jdt, tdt = DTYPES[dtype]
    jp = JM.make_moe_params(jax.random.PRNGKey(3), jcfg, jdt)
    tp = _to_torch(jp, tdt)
    assert tp["router"].dtype == torch.float32
    x = np.random.default_rng(0).normal(size=(2, 24, jcfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jdt)
    tx = torch.from_numpy(_np(jx)).to(tdt)

    jout, jaux = JM.moe_apply(jp, jcfg, jx)
    tout, taux = TM.moe_apply(tp, tcfg, tx)
    assert tout.dtype == tdt and taux.dtype == torch.float32
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL[dtype])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)

    # the dispatch: repro's top-k choice, ranked independently
    t = x.shape[0] * x.shape[1]
    logits = jx.reshape(t, -1).astype(jnp.float32) @ jp["router"]
    _, jidx, _ = JM._router_probs(jcfg, logits)
    tlogits = tx.reshape(t, -1).float() @ tp["router"]
    _, tidx, _ = TM._router_probs(tcfg, tlogits)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    cap = max(1, int(t * jcfg.top_k * jcfg.capacity_factor
                     / jcfg.n_experts))
    assert TM.capacity(tcfg, t) == cap
    flat_e, pos, keep, counts = TM._dispatch(tidx, tcfg.n_experts, cap)
    want_e = np.asarray(jidx).reshape(-1)
    want_pos = _ranks(want_e)
    np.testing.assert_array_equal(flat_e.numpy(), want_e)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_pos < cap)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(want_e, minlength=jcfg.n_experts))
    dropped = int((~keep).sum())
    assert (dropped > 0) == (cf is not None), dropped


def test_moe_params_have_repros_shapes_and_types():
    for arch in MOE_ARCHS:
        jcfg, tcfg = _moe_cfgs(arch, None)
        jp = JM.make_moe_params(jax.random.PRNGKey(0), jcfg)
        tp = TM.make_moe_params(torch.Generator().manual_seed(0), tcfg)

        def spec(tree):
            if isinstance(tree, dict):
                return {k: spec(v) for k, v in tree.items()}
            return (tuple(tree.shape), str(tree.dtype).split(".")[-1])

        assert spec(tp) == spec(jp), arch


# reduced deepseek-v3's MLA (4 heads, latent 32, rope 8, nope 16, v 16);
# the dense path (S <= dense_threshold) and the chunked one (S=48 over
# chunks of 16)
MLA_CASES = [({}, 24), ({"dense_threshold": 16, "chunk_size": 16}, 48)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attn,s", MLA_CASES, ids=["dense", "chunked"])
def test_mla_prefill_and_decode_match_repro(attn, s, dtype):
    jcfg = dataclasses.replace(repro_config("deepseek-v3-671b").attn, **attn)
    tcfg = dataclasses.replace(get_reduced_config("deepseek-v3-671b").attn,
                               **attn)
    jdt, tdt = DTYPES[dtype]
    jp = JA.make_attention_params(jax.random.PRNGKey(1), jcfg, jdt)
    tp = _to_torch(jp, tdt)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, s + 3, jcfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jdt)
    tx = torch.from_numpy(_np(jx)).to(tdt)

    jout, jc = JA.mla_prefill(jp, jcfg, jx[:, :s], jnp.arange(s))
    tout, tc = TA.mla_prefill(tp, tcfg, tx[:, :s], torch.arange(s))
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL[dtype])
    assert set(tc) == set(jc) == {"c", "k_rope"}
    for key in jc:
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL[dtype])
    np.testing.assert_allclose(
        _np(TA.mla_forward(tp, tcfg, tx[:, :s], torch.arange(s))),
        _np(tout), atol=0, rtol=0)

    # three decode steps into caches padded to s + 3, written in place
    smax = s + 3
    jc = {k: jnp.pad(v, ((0, 0), (0, smax - s), (0, 0))) for k, v in
          jc.items()}
    tc = {k: torch.nn.functional.pad(v, (0, 0, 0, smax - s))
          for k, v in tc.items()}
    for i in range(3):
        jo, jc = JA.mla_decode(jp, jcfg, jx[:, s + i:s + i + 1], jc,
                               jnp.int32(s + i))
        cache = tc
        to, tc = TA.mla_decode(tp, tcfg, tx[:, s + i:s + i + 1], tc, s + i)
        assert tc["c"] is cache["c"]
        np.testing.assert_allclose(_np(to), _np(jo), **TOL[dtype])
    for key in jc:
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL[dtype])
