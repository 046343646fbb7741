"""The port's decoder stack against the JAX package's, on the CPU.

``repro``'s ``init_params`` is carried across with ``params_from_numpy``;
prompts and decode tokens are drawn with NumPy from a seed and fed to both.
Prefill logits and four decode steps are compared, for every reduced
config: MLA, MoE, MTP (built, not run by serving), prefix embeddings and
codebooks included.

Tolerances: float32 1e-5 (absolute and relative; logits are ~0.5 and the
two frameworks differ by ~6e-7, summation order only).  bfloat16 3e-2
absolute: one bf16 ulp at 0.5 is 2e-3 and the two frameworks round
intermediates at different places (observed at most ~9e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as repro_config
from repro.models import transformer as JT
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.models.attention import (AttentionConfig, gqa_decode,
                                          gqa_prefill, make_attention_params)

TOL = {"f32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=3e-2, rtol=0)}


def _configs(arch: str, dtype: str):
    """repro's and the port's reduced config.  In bfloat16 a model with MoE
    layers is held against ``repro``'s unit loop (``scan_units=False``), the
    port's own structure: under ``lax.scan`` XLA compiles the unit as one
    computation and keeps some bf16 intermediates wider, and a top-k choice
    that flips there moves whole expert outputs (reduced deepseek-v3's
    decode logits miss 3e-2 under the scan)."""
    jcfg, tcfg = repro_config(arch), get_reduced_config(arch)
    if dtype == "f32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    elif jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, scan_units=False)
    return jcfg, tcfg


def _params(jcfg, tcfg):
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp)
    return jp, params_from_numpy(tree, tcfg, device="cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(cfg, rng, b: int, s: int):
    """Tokens [b, s] ([b, s, CB] with codebooks) and prefix embeddings
    [b, n_prefix, d_model] (None without a prefix), as NumPy."""
    shape = (b, s, cfg.codebooks) if cfg.codebooks > 1 else (b, s)
    toks = rng.integers(0, cfg.vocab, size=shape)
    pe = (rng.normal(size=(b, cfg.n_prefix, cfg.d_model)) * 0.02
          if cfg.n_prefix else None)
    return toks, pe


def _prefix(pe, jcfg, tcfg):
    """The same prefix embeddings for both, rounded to the model's type."""
    if pe is None:
        return None, None
    jpe = jnp.asarray(pe, jnp.float32).astype(jcfg.dtype)
    return jpe, torch.from_numpy(_np(jpe).copy()).to(tcfg.dtype)


# (arch, prompt length, max_len): gemma3's local layers see a window of 32,
# so S=40 crosses it in prefill and masks it in decode; max_len 32 <= window
# gives those layers a ring cache; starcoder2 has the ungated GELU MLP;
# mamba2's and jamba's prompt of 40 is padded to their chunk of 16;
# deepseek-v3 has MLA and MoE (sigmoid router, shared expert), arctic MoE
# with a dense branch, jamba MoE every other layer; musicgen 4 codebooks and
# 8 prefix positions, paligemma 16 prefix positions (max_len counts the
# prompt's tokens; the caches add the prefix)
CASES = [("yi-6b", 24, 32), ("gemma3-27b", 40, 48), ("gemma3-27b", 26, 32),
         ("starcoder2-7b", 24, 32), ("mamba2-1.3b", 40, 48),
         ("deepseek-v3-671b", 24, 32), ("arctic-480b", 24, 32),
         ("jamba-1.5-large-398b", 40, 48), ("musicgen-large", 24, 32),
         ("paligemma-3b", 24, 32)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,s,max_len", CASES)
def test_prefill_and_decode_match_repro(arch, s, max_len, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(0)
    toks, pe = _inputs(jcfg, rng, 2, s)
    jpe, tpe = _prefix(pe, jcfg, tcfg)
    cache_len = max_len + jcfg.n_prefix
    jl, jc, jn = JT.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), jpe,
                            max_len=cache_len)
    tl, tc, tn = TT.prefill(tp, tcfg, torch.from_numpy(toks), tpe,
                            max_len=cache_len)
    assert jn == tn == s + jcfg.n_prefix and tl.dtype == tcfg.dtype
    assert tl.shape == jl.shape
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])
    for i in range(4):
        tok = _inputs(jcfg, rng, 2, 1)[0][:, 0]
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                                jnp.int32(jn + i))
        tl, tc = TT.decode_step(tp, tcfg, torch.from_numpy(tok), tc, tn + i)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])


@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-27b", "mamba2-1.3b",
                                  "deepseek-v3-671b", "arctic-480b",
                                  "jamba-1.5-large-398b", "musicgen-large",
                                  "paligemma-3b"])
def test_init_params_has_repros_structure(arch):
    jcfg, tcfg = _configs(arch, "bf16")
    _, carried = _params(jcfg, tcfg)
    gen = torch.Generator().manual_seed(0)
    own = TT.init_params(gen, tcfg, device="cpu")

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [spec(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert spec(own) == spec(carried)
    assert len(own["units"]) == tcfg.n_units


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large"])
def test_decode_at_length_matches_forward(arch):
    """Teacher-forced decode of the next token at ``length`` (what prefill
    returns, prefix included) gives ``forward``'s last logits on the
    extended sequence; float32, 1e-5."""
    _, cfg = _configs(arch, "f32")
    tp = TT.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks, pe = _inputs(cfg, np.random.default_rng(1), 2, 17)
    toks = torch.from_numpy(toks)
    pe = torch.from_numpy(pe.astype(np.float32))
    _, caches, length = TT.prefill(tp, cfg, toks[:, :-1], pe,
                                   max_len=16 + 4 + cfg.n_prefix)
    assert length == 16 + cfg.n_prefix
    got, _ = TT.decode_step(tp, cfg, toks[:, -1], caches, length)
    want = TT.forward(tp, cfg, toks, pe)[0][:, -1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_ring_cache_decode_matches_full_prefill():
    """A window-sized ring cache, wrapped, gives the full prefill's output."""
    cfg = AttentionConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                          window=8, dense_threshold=10**9)
    gen = torch.Generator().manual_seed(0)
    p = make_attention_params(gen, cfg, torch.float32)
    b, s = 2, 24
    x = torch.randn((b, s + 1, 32), generator=gen) * 0.5
    ref, _ = gqa_prefill(p, cfg, x, torch.arange(s + 1))
    _, cache = gqa_prefill(p, cfg, x[:, :s], torch.arange(s))
    # ring of size window=8 holding the last 8 tokens; S % 8 == 0 aligns
    ring = {k: v[:, s - 8:s].clone() for k, v in cache.items()}
    out, _ = gqa_decode(p, cfg, x[:, s:s + 1], ring, s)
    np.testing.assert_allclose(out[:, 0].numpy(), ref[:, -1].numpy(),
                               atol=2e-5, rtol=2e-5)


def _clone(tree):
    return torch.utils._pytree.tree_map(torch.clone, tree)


def _bitwise(a, b) -> bool:
    la, lb = (torch.utils._pytree.tree_leaves(t) for t in (a, b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.view(torch.uint8),
                                           y.view(torch.uint8))
        for x, y in zip(la, lb))


# gemma3's prompt of 26 and caches of 32 <= its window make its local layers
# ring caches; deepseek-v3 has MLA and MoE, musicgen codebooks and a prefix
@pytest.mark.parametrize("arch,s,max_len", [
    ("yi-6b", 24, 32), ("gemma3-27b", 26, 32), ("mamba2-1.3b", 40, 48),
    ("deepseek-v3-671b", 24, 32), ("musicgen-large", 24, 32)])
def test_decode_step_takes_a_tensor_position_bitwise(arch, s, max_len):
    """``decode_step`` at a 0-d int64 tensor position (what a captured
    decode step reads) gives bitwise the logits and caches of the same
    call at a Python int, over four steps of the served type (bf16)."""
    cfg = get_reduced_config(arch)
    tp = TT.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    toks, pe = _inputs(cfg, rng, 2, s)
    pe = None if pe is None else torch.from_numpy(pe).to(cfg.dtype)
    _, at_int, n = TT.prefill(tp, cfg, torch.from_numpy(toks), pe,
                              max_len=max_len + cfg.n_prefix)
    at_tensor = _clone(at_int)
    for i in range(4):
        tok = torch.from_numpy(_inputs(cfg, rng, 2, 1)[0][:, 0])
        want, at_int = TT.decode_step(tp, cfg, tok, at_int, n + i)
        got, at_tensor = TT.decode_step(tp, cfg, tok, at_tensor,
                                        torch.tensor(n + i))
        assert _bitwise(got, want), i
        assert _bitwise(at_tensor, at_int), i


def test_ring_cache_wraps_at_a_tensor_position_bitwise():
    """A ring cache of 8 written past its end (positions 24-27 land in
    slots 0-3): a tensor position gives bitwise the int's outputs and
    cache."""
    cfg = AttentionConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                          window=8)
    gen = torch.Generator().manual_seed(1)
    p = make_attention_params(gen, cfg, torch.float32)
    x = torch.randn((2, 28, 32), generator=gen)
    _, cache = gqa_prefill(p, cfg, x[:, :24], torch.arange(24))
    ring = {k: v[:, 16:24].clone() for k, v in cache.items()}
    ring_t = _clone(ring)
    for pos in range(24, 28):
        want, ring = gqa_decode(p, cfg, x[:, pos:pos + 1], ring, pos)
        got, ring_t = gqa_decode(p, cfg, x[:, pos:pos + 1], ring_t,
                                 torch.tensor(pos))
        assert _bitwise(got, want) and _bitwise(ring_t, ring), pos
