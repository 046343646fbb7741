"""The port's serving engine against the JAX package's, on the CPU.

Reduced ``yi-6b`` in float32 with ``repro``'s parameters carried across;
both engines see the traffic of ``launch/serve.py`` (three recurring
clients in turn, one request every 20 s of simulated time) and must emit
identical greedy tokens and prewarm (``prefetched``) flags; so must reduced
deepseek-v3 (MLA, MoE).  With prefix embeddings the port decodes at
``prefill``'s ``length``, where ``repro``'s engine decodes ``n_prefix``
positions later; two tests show which of the two agrees with ``forward``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as repro_config
from repro.models import transformer as JT
from repro.models.transformer import init_params as repro_init
from repro.serve import engine as JE
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE


def _engines(max_len):
    jcfg = dataclasses.replace(repro_config("yi-6b"), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced_config("yi-6b"),
                               dtype=torch.float32)
    jp = repro_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a), jp)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    return (JE.ServeEngine(jcfg, jp, max_len=max_len),
            TE.ServeEngine(tcfg, tp, max_len=max_len, device="cpu"))


def _traffic(n, prompt_len, vocab, jitter):
    """``launch/serve.py``'s requests; ``jitter`` moves each arrival by a
    fixed fraction of the 20 s gap (alternating sign)."""
    now, out = 0.0, []
    for i in range(n):
        client = i % 3
        prompt = (np.arange(prompt_len) * (client + 3)) % vocab
        out.append((i, client, now, prompt))
        now += 20.0 * (1 + jitter * (-1) ** (i // 3))
    return out


@pytest.mark.parametrize("n,jitter", [(12, 0.0), (15, 0.0), (15, 0.05)])
def test_tokens_and_prewarm_flags_match_repro(n, jitter):
    prompt_len, max_new = 32, 8
    jeng, teng = _engines(prompt_len + max_new + 8)
    for i, client, now, prompt in _traffic(n, prompt_len, 256, jitter):
        jc = jeng.serve(JE.Request(i, client, now, prompt, max_new), now)
        tc = teng.serve(TE.Request(i, client, now, prompt, max_new), now)
        assert tc.tokens == [int(t) for t in jc.tokens], i
        assert tc.prefetched == jc.prefetched, i
        assert tc.ttft >= 0 and tc.done_at >= tc.first_token_at
    assert teng.stats == jeng.stats
    assert teng.stats["prefetched_prefills"] == (3 if n == 15 else 0)


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config("yi-6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.ServeEngine(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "yi-6b", "--reduced"])


def test_launcher_serves_on_the_cpu(capsys):
    engine = launch_serve.main(["--arch", "mamba2-1.3b", "--reduced",
                                "--device", "cpu", "--requests", "5",
                                "--prompt-len", "20", "--max-new", "3"])
    assert engine.stats == {"prefetched_prefills": 0, "total": 5}
    assert "served 5" in capsys.readouterr().out


def test_moe_mla_tokens_match_repro():
    """Reduced deepseek-v3 (MLA, MoE) in float32: the two engines' greedy
    tokens and prewarm flags on six requests of the launcher's traffic."""
    jcfg = dataclasses.replace(repro_config("deepseek-v3-671b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced_config("deepseek-v3-671b"),
                               dtype=torch.float32)
    jp = repro_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    jeng = JE.ServeEngine(jcfg, jp, max_len=32)
    teng = TE.ServeEngine(tcfg, tp, max_len=32, device="cpu")
    for i, client, now, prompt in _traffic(6, 20, 256, 0.0):
        jc = jeng.serve(JE.Request(i, client, now, prompt, 6), now)
        tc = teng.serve(TE.Request(i, client, now, prompt, 6), now)
        assert tc.tokens == [int(t) for t in jc.tokens], i
        assert tc.prefetched == jc.prefetched, i


def _paligemma_repro_engine():
    cfg = dataclasses.replace(repro_config("paligemma-3b"), dtype=jnp.float32)
    params = repro_init(jax.random.PRNGKey(0), cfg)
    return cfg, params, JE.ServeEngine(cfg, params, max_len=48)


def test_repro_engine_decodes_past_the_prefix():
    """Why the port's engine decodes at ``length``: ``repro``'s
    ``ServeEngine.serve`` decodes at ``length + n_prefix``, but ``prefill``'s
    ``length`` holds the prefix already.  Reduced paligemma-3b (16 prefix
    positions), a 32-token prompt, caches of 48 + 16: decoding the next
    token at ``length`` (48) gives ``forward``'s logits on the extended
    sequence; at the engine's position (64) the write lands past the cache,
    where ``dynamic_update_slice`` clamps it, and the logits disagree."""
    cfg, params, engine = _paligemma_repro_engine()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=33)
    _, caches, length = engine._prefill(toks[:32])
    assert length == 32 + cfg.n_prefix == 48
    pe = jnp.zeros((1, cfg.n_prefix, cfg.d_model), jnp.bfloat16)
    want = np.asarray(JT.forward(params, cfg, jnp.asarray(toks)[None],
                                 pe)[0][0, -1])
    nxt = jnp.asarray(toks[32:33], jnp.int32)
    at_length = np.asarray(engine._decode(params, nxt, caches,
                                          jnp.int32(length))[0][0])
    pos = jnp.int32(length + cfg.n_prefix)
    at_engine = np.asarray(engine._decode(params, nxt, caches, pos)[0][0])
    np.testing.assert_allclose(at_length, want, atol=1e-4, rtol=1e-4)
    assert np.abs(at_engine - want).max() > 0.1


def test_port_engine_decodes_at_length():
    """The port's engine on the same model and prompt: its first decode
    step, at ``length``, gives ``forward``'s logits on the prompt extended
    by the first greedy token (float32, 1e-4)."""
    cfg, params, _ = _paligemma_repro_engine()
    tcfg = dataclasses.replace(get_reduced_config("paligemma-3b"),
                               dtype=torch.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                           device="cpu")
    engine = TE.ServeEngine(tcfg, tp, max_len=48, device="cpu")
    seen = []
    inner = TE.decode_step

    def spy(p, c, tok, caches, pos):
        logits, caches = inner(p, c, tok, caches, pos)
        # the decode program's position is a tensor it advances in place
        seen.append((int(pos), logits))
        return logits, caches

    prompt = np.random.default_rng(0).integers(0, tcfg.vocab, size=32)
    TE.decode_step = spy
    try:
        comp = engine.serve(TE.Request(0, 0, 0.0, prompt, 2), 0.0)
    finally:
        TE.decode_step = inner
    assert seen[0][0] == 32 + tcfg.n_prefix
    toks = torch.from_numpy(np.append(prompt, comp.tokens[0]))[None]
    pe = torch.zeros((1, tcfg.n_prefix, tcfg.d_model))
    want = TT.forward(tp, tcfg, toks, pe)[0][0, -1]
    np.testing.assert_allclose(seen[0][1][0].numpy(), want.numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["musicgen-large", "paligemma-3b",
                                  "jamba-1.5-large-398b"])
def test_launcher_serves_prefix_and_codebook_models_on_the_cpu(arch):
    engine = launch_serve.main(["--arch", arch, "--reduced", "--device",
                                "cpu", "--requests", "4", "--prompt-len",
                                "16", "--max-new", "3"])
    assert engine.stats["total"] == 4


def _plain_decode(params, cfg, caches, tok, pos, steps):
    """The per-token loop the engine ran before its decode program: each
    step's input token, as a list."""
    out = []
    for i in range(steps):
        out.append(tok.tolist())
        logits, caches = TT.decode_step(params, cfg, tok[None], caches,
                                        pos + i)
        tok = torch.argmax(logits[0], dim=-1)
    return out


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large",
                                  "mamba2-1.3b", "jamba-1.5-large-398b"])
def test_decode_program_matches_a_plain_decode_loop(arch):
    """Reduced prefix (paligemma), codebook (musicgen) and Mamba models
    (states copied back into the program's buffers): the engine's decode
    program, run eagerly as on the CPU, gives the tokens of a plain
    per-token ``decode_step`` loop and leaves the prefill's caches as they
    were; so does ``serve`` on two requests."""
    cfg = get_reduced_config(arch)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    engine = TE.ServeEngine(cfg, params, max_len=32, device="cpu")
    rng = np.random.default_rng(0)
    shape = (20, cfg.codebooks) if cfg.codebooks > 1 else (20,)
    prompts = [rng.integers(0, cfg.vocab, size=shape) for _ in range(2)]
    for i, prompt in enumerate(prompts):
        logits, caches, length = engine._prefill(prompt)
        tok = torch.argmax(logits[0], dim=-1)
        kept = torch.utils._pytree.tree_map(torch.clone, caches)
        want = _plain_decode(params, cfg, kept, tok, length, 8)
        got = engine.serve(TE.Request(i, i, 0.0, prompt, 8), 0.0).tokens
        assert got == want, i
        program = engine.program
        assert program.decode(caches, tok, length, 8).tolist() == want, i
        leaves = torch.utils._pytree.tree_leaves
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(caches), leaves(engine._prefill(prompt)[1])))
    assert program.graph is None


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_decode_program_makes_no_mamba_state_copy(arch, monkeypatch):
    """Reduced Mamba models on the CPU: every cache ``decode_step`` returns
    to the decode program is its own buffer, written in place, so the
    program copies none of them back (no ``copy_`` takes a returned state
    as its source) and its tokens are the plain loop's; the prefill's
    caches stay as they were."""
    cfg = get_reduced_config(arch)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    engine = TE.ServeEngine(cfg, params, max_len=32, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=20)
    logits, caches, length = engine._prefill(prompt)
    kept = torch.utils._pytree.tree_map(torch.clone, caches)
    tok = torch.argmax(logits[0], dim=-1)
    want = _plain_decode(params, cfg, torch.utils._pytree.tree_map(
        torch.clone, caches), tok, length, 6)
    program = TE.DecodeProgram(params, cfg, caches, tok)
    leaves = torch.utils._pytree.tree_leaves
    returned, sources = [], []
    inner_step, inner_copy = TE.decode_step, torch.Tensor.copy_

    def step(*a):
        logits, new = inner_step(*a)
        returned.append(leaves(new))
        return logits, new

    def copy_(dst, src, *a, **kw):
        sources.append(src)
        return inner_copy(dst, src, *a, **kw)

    monkeypatch.setattr(TE, "decode_step", step)
    monkeypatch.setattr(torch.Tensor, "copy_", copy_)
    got = program.decode(caches, tok, length, 6).tolist()
    monkeypatch.undo()
    assert got == want
    assert len(returned) == 6
    bufs = leaves(program.caches)
    assert all(all(a is b for a, b in zip(new, bufs)) for new in returned)
    assert not any(src is t for src in sources for new in returned
                   for t in new)
    assert all(torch.equal(a, b) for a, b in zip(leaves(caches),
                                                 leaves(kept)))


def test_engine_refuses_a_request_past_max_len():
    """A captured step cannot check its write position on the host: the
    engine refuses a request whose prompt and new tokens pass
    ``max_len`` before it prefills."""
    cfg = get_reduced_config("yi-6b")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    engine = TE.ServeEngine(cfg, params, max_len=24, device="cpu")
    with pytest.raises(ValueError, match="max_len=24"):
        engine.serve(TE.Request(0, 0, 0.0, np.arange(20), 5), 0.0)
    assert engine.stats["total"] == 0
