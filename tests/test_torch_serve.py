"""The port's serving engine against the JAX package's, on the CPU.

Reduced ``yi-6b`` in float32 with ``repro``'s parameters carried across;
both engines see the traffic of ``launch/serve.py`` (three recurring
clients in turn, one request every 20 s of simulated time) and must emit
identical greedy tokens and prewarm (``prefetched``) flags.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as repro_config
from repro.models.transformer import init_params as repro_init
from repro.serve import engine as JE
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
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
