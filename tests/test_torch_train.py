"""The port's training path against the JAX package's, on the CPU: the loss
and its gradients, AdamW, the train step (one batch and two microbatches),
remat, NaN-step skipping, and 30 steps that lower the loss.

``repro``'s ``init_params`` is carried across with ``params_from_numpy``,
and so is its gradient tree, which has the same layout; batches are drawn
with NumPy from a seed and fed to both.

Tolerances: float32 loss and gradients 1e-5 (absolute and relative; the
two frameworks differ by summation order only); AdamW fed the same inputs
1e-6 relative (the same float32 operations, element by element).  After a
train step the parameters agree to 2·lr: Adam's first step moves every
entry by about ±lr, so where the two gradients are ~1e-9 with opposite
signs the two steps differ by up to 2·lr; the number of such entries is
reported.  Both decay every parameter of ndim >= 2 in ``repro``'s stacked
layout, the units' vectors included, so ``repro``'s parameters are
compared as they come out.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_reduced_config as repro_config
from repro.models import transformer as JT
from repro.train import loop as JL
from repro.train import optimizer as JO
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import PrefetchingLoader, SyntheticLM
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as TO

F32 = dict(atol=1e-5, rtol=1e-5)


def _configs(arch: str, **attn):
    """repro's and the port's reduced float32 config; ``attn`` overrides
    the attention configs' fields (both of gemma3's)."""
    jcfg = dataclasses.replace(repro_config(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32)
    if attn:
        out = []
        for cfg in (jcfg, tcfg):
            kw = {k: dataclasses.replace(getattr(cfg, k), **attn)
                  for k in ("attn", "attn_global")
                  if getattr(cfg, k) is not None}
            out.append(dataclasses.replace(cfg, **kw))
        jcfg, tcfg = out
    return jcfg, tcfg


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), tree)


def _params(jcfg, tcfg):
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(_to_numpy(jp), tcfg, device="cpu")


def _batch(vocab: int, b: int, s: int, seed: int = 0, cfg=None):
    """The same batch for both; ``cfg`` (repro's) adds codebooks and
    prefix embeddings where the model has them."""
    rng = np.random.default_rng(seed)
    cb = cfg.codebooks if cfg is not None else 1
    shape = (b, s + 1, cb) if cb > 1 else (b, s + 1)
    toks = rng.integers(0, vocab, size=shape).astype(np.int32)
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg is not None and cfg.n_prefix:
        nb["prefix_embeddings"] = (rng.normal(
            size=(b, cfg.n_prefix, cfg.d_model)) * 0.02).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in nb.items()})


def _loss_and_grads(params, cfg, batch):
    leaves, spec = pytree.tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    total, metrics = TT.loss_fn(pytree.tree_unflatten(live, spec), cfg,
                                batch)
    grads = torch.autograd.grad(total, live)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            pytree.tree_unflatten(list(grads), spec))


def _assert_trees_close(got, want, **tol):
    g_leaves, g_spec = pytree.tree_flatten(got)
    w_leaves, w_spec = pytree.tree_flatten(want)
    assert g_spec == w_spec
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   **tol)


def _jax_loss_and_grads(jp, jcfg, jbatch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True))
    (total, metrics), grads = fn(jp, jbatch)
    return total, metrics, grads


# (arch, attention overrides, batch, sequence): gemma3's local layers see a
# window of 32, so S=40 crosses it; starcoder2 has the ungated GELU MLP;
# mamba2's S=40 is padded to its chunk of 16.  The two chunked cases run
# chunked_attention (S=48 > dense_threshold=16, chunks of 16) in the
# forward and the backward, gemma3's with its window.  deepseek-v3 adds MLA,
# MoE (aux loss) and the MTP loss; arctic and jamba MoE; musicgen the
# codebook loss over [B,S,4,V] logits after its 8 prefix positions;
# paligemma 16 prefix positions.
LOSS_CASES = [
    ("yi-6b", {}, 2, 24),
    ("gemma3-27b", {}, 2, 40),
    ("starcoder2-7b", {}, 2, 24),
    ("mamba2-1.3b", {}, 2, 40),
    ("yi-6b", {"dense_threshold": 16, "chunk_size": 16}, 2, 48),
    ("gemma3-27b", {"dense_threshold": 16, "chunk_size": 16}, 2, 48),
    ("deepseek-v3-671b", {}, 2, 24),
    ("arctic-480b", {}, 2, 24),
    ("jamba-1.5-large-398b", {}, 2, 40),
    ("musicgen-large", {}, 2, 24),
    ("paligemma-3b", {}, 2, 24),
]


@pytest.mark.parametrize("arch,attn,b,s", LOSS_CASES,
                         ids=[f"{a}-{'chunked' if o else 'dense'}"
                              for a, o, _, _ in LOSS_CASES])
def test_loss_and_grads_match_repro(arch, attn, b, s):
    jcfg, tcfg = _configs(arch, **attn)
    jp, tp = _params(jcfg, tcfg)
    jbatch, tbatch = _batch(jcfg.vocab, b, s, cfg=jcfg)
    jtotal, jmetrics, jgrads = _jax_loss_and_grads(jp, jcfg, jbatch)
    ttotal, tmetrics, tgrads = _loss_and_grads(tp, tcfg, tbatch)
    assert set(tmetrics) == set(jmetrics) == {"loss", "aux"}
    np.testing.assert_allclose(float(ttotal), float(jtotal), **F32)
    np.testing.assert_allclose(float(tmetrics["loss"]),
                               float(jmetrics["loss"]), **F32)
    np.testing.assert_allclose(float(tmetrics["aux"]),
                               float(jmetrics["aux"]), **F32)
    assert (float(tmetrics["aux"]) > 0) == (tcfg.moe is not None)
    want = params_from_numpy(_to_numpy(jgrads), tcfg, device="cpu")
    _assert_trees_close(tgrads, want, **F32)


def test_chunked_attention_backward_matches_dense():
    """The online-softmax carry is differentiable and gives the dense
    path's gradients (window and GQA included)."""
    rng = np.random.default_rng(0)
    shapes = [(2, 64, 4, 8), (2, 64, 2, 8), (2, 64, 2, 8)]
    grads = []
    for fn in (TA.dense_attention, TA.chunked_attention):
        q, k, v = (torch.tensor(rng.normal(size=sh), dtype=torch.float32,
                                requires_grad=True) for sh in shapes)
        rng = np.random.default_rng(0)
        kw = {"chunk_size": 16} if fn is TA.chunked_attention else {}
        out = fn(q, k, v, causal=True, window=20, **kw)
        w = torch.from_numpy(np.random.default_rng(1).normal(
            size=out.shape).astype(np.float32))
        (out * w).sum().backward()
        grads.append((out.detach(), q.grad, k.grad, v.grad))
    for d, c in zip(*grads):
        np.testing.assert_allclose(c.numpy(), d.numpy(), atol=2e-5,
                                   rtol=2e-5)


def _random_tree(rng, shapes):
    return {k: np.asarray(rng.normal(size=sh), np.float32)
            for k, sh in shapes.items()}


@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clipped", "unclipped"])
def test_adamw_update_matches_repro(clip):
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 6), "b": (6,), "k": (3, 4, 5), "s": ()}
    params = _random_tree(rng, shapes)
    grads = {k: 3 * v for k, v in _random_tree(rng, shapes).items()}
    m = {k: 0.1 * v for k, v in _random_tree(rng, shapes).items()}
    v = {k: np.abs(a) * 0.01 for k, a in _random_tree(rng, shapes).items()}
    jcfg = JO.AdamWConfig(lr=1e-2, grad_clip=clip)
    tcfg = TO.AdamWConfig(lr=1e-2, grad_clip=clip)

    def j(tree):
        return {k: jnp.asarray(a, jnp.float32) for k, a in tree.items()}

    def t(tree):
        return {k: torch.from_numpy(np.asarray(a, np.float32))
                for k, a in tree.items()}

    jout = JO.adamw_update(j(grads), {"m": j(m), "v": j(v),
                                      "step": jnp.int32(4)}, j(params), jcfg)
    step = torch.tensor(4, dtype=torch.int32)
    tout = TO.adamw_update(t(grads), {"m": t(m), "v": t(v), "step": step},
                           t(params), tcfg)
    np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=1e-6)
    assert int(tout[1]["step"]) == int(jout[1]["step"]) == 5
    for tt, jt in ((tout[0], jout[0]), (tout[1]["m"], jout[1]["m"]),
                   (tout[1]["v"], jout[1]["v"])):
        for key in shapes:
            np.testing.assert_allclose(tt[key].numpy(), np.asarray(jt[key]),
                                       rtol=1e-6, atol=0)


def test_adamw_decays_stacked_unit_vectors_as_repro():
    """``repro`` stacks the units on a leading axis and decays ndim >= 2
    there: a unit's vectors decay, while its scalars and the vectors
    outside the units do not.  The port's list of units takes the same
    steps."""
    rng = np.random.default_rng(2)
    n, d = 3, 4
    shapes = {"embed": (5, d), "final_norm": (d,),
              "units": {"scale": (n, d), "w": (n, d, d), "g": (n,)}}

    def draw(f=lambda a: a):
        return jax.tree_util.tree_map(
            lambda sh: f(np.asarray(rng.normal(size=sh), np.float32)),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    p, g, m = draw(), draw(), draw()
    v = draw(lambda a: np.abs(a) * 0.01)

    def listed(tree):
        """The port's layout: a list over units of a one-layer pattern."""
        out = {k: torch.from_numpy(np.array(tree[k]))
               for k in ("embed", "final_norm")}
        out["units"] = [[{u: torch.from_numpy(np.array(a[i]))
                          for u, a in tree["units"].items()}]
                        for i in range(n)]
        return out

    def port(weight_decay):
        state = {"m": listed(m), "v": listed(v),
                 "step": torch.tensor(2, dtype=torch.int32)}
        cfg = TO.AdamWConfig(lr=1e-2, weight_decay=weight_decay)
        return TO.adamw_update(listed(g), state, listed(p), cfg)[0]

    jstate = {"m": m, "v": v, "step": np.int32(2)}
    jout = JO.adamw_update(*jax.tree_util.tree_map(jnp.asarray,
                                                   (g, jstate, p)),
                           JO.AdamWConfig(lr=1e-2))[0]
    got = port(0.1)
    want = listed(jax.tree_util.tree_map(np.asarray, jout))
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0)
    # the rule itself: the units' vectors decay; their scalars and
    # final_norm do not
    undecayed = port(0.0)
    for i in range(n):
        assert not torch.equal(got["units"][i][0]["scale"],
                               undecayed["units"][i][0]["scale"])
        assert torch.equal(got["units"][i][0]["g"],
                           undecayed["units"][i][0]["g"])
    assert torch.equal(got["final_norm"], undecayed["final_norm"])


def test_adamw_decays_experts_and_mtp_as_repro():
    """Reduced deepseek-v3's real parameter tree: stacked expert weights
    ([n_units, E, d, f] in ``repro``), float32 routers, the shared expert
    and the unstacked ``mtp`` subtree take the same AdamW step in both;
    ``mtp``'s norm (a vector outside the units) does not decay, its
    matrices and router do."""
    jcfg, tcfg = _configs("deepseek-v3-671b")
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(3)
    draw = [jax.tree_util.tree_map(
        lambda a: np.asarray(rng.normal(size=a.shape), np.float32), jp)
        for _ in range(3)]
    g, m, v = draw[0], draw[1], jax.tree_util.tree_map(
        lambda a: np.abs(a) * 0.01, draw[2])
    ocfg = JO.AdamWConfig(lr=1e-2)
    jout = jax.jit(lambda *a: JO.adamw_update(*a, ocfg)[0])(
        *jax.tree_util.tree_map(jnp.asarray, (g, {"m": m, "v": v,
                                                 "step": np.int32(2)}, jp)))

    def port(weight_decay):
        state = {"m": params_from_numpy(m, tcfg, device="cpu"),
                 "v": params_from_numpy(v, tcfg, device="cpu"),
                 "step": torch.tensor(2, dtype=torch.int32)}
        return TO.adamw_update(params_from_numpy(g, tcfg, device="cpu"),
                               state, tp, TO.AdamWConfig(
                                   lr=1e-2, weight_decay=weight_decay))[0]

    got = port(0.1)
    want = params_from_numpy(_to_numpy(jout), tcfg, device="cpu")
    # 1e-6 relative, and 1e-7 absolute where the step cancels a parameter
    # (about one float32 ulp of the operands, which are below ~1)
    _assert_trees_close(got, want, rtol=1e-6, atol=1e-7)
    undecayed = port(0.0)
    assert torch.equal(got["mtp"]["norm"], undecayed["mtp"]["norm"])
    for key in ("in_proj",):
        assert not torch.equal(got["mtp"][key], undecayed["mtp"][key])
    for tree in (got["mtp"]["layer"], got["units"][0][0]):
        und = (undecayed["mtp"]["layer"] if tree is got["mtp"]["layer"]
               else undecayed["units"][0][0])
        for key in ("router", "w_gate"):
            assert not torch.equal(tree["mlp"][key], und["mlp"][key])
    assert not torch.equal(got["units"][0][0]["norm1"],
                           undecayed["units"][0][0]["norm1"])


# test_substrate.py's three optimizer cases, through the port

def test_adamw_reduces_quadratic():
    cfg = TO.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = TO.adamw_init(params, cfg)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, _ = TO.adamw_update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.2


def test_bf16_moments():
    cfg = TO.AdamWConfig(moment_dtype=torch.bfloat16)
    params = {"w": torch.ones((4, 4))}
    state = TO.adamw_init(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    params2, state2, _ = TO.adamw_update({"w": torch.ones((4, 4))}, state,
                                         params, cfg)
    assert state2["m"]["w"].dtype == torch.bfloat16
    assert not torch.allclose(params2["w"], params["w"])


def test_grad_clip():
    cfg = TO.AdamWConfig(grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    state = TO.adamw_init(params, cfg)
    _, _, gnorm = TO.adamw_update({"w": torch.full((3,), 1e6)}, state,
                                  params, cfg)
    assert float(gnorm) > 1e5   # reported raw norm


@pytest.mark.parametrize("arch,micro", [("yi-6b", 1), ("yi-6b", 2),
                                        ("mamba2-1.3b", 2),
                                        ("deepseek-v3-671b", 1)])
def test_train_step_matches_repro(arch, micro):
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg, tcfg)
    jbatch, tbatch = _batch(jcfg.vocab, 4, 32, seed=1, cfg=jcfg)
    jt = JL.TrainConfig(microbatches=micro)
    tt = TL.TrainConfig(microbatches=micro)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jstep = JL.make_train_step(jcfg, jt, mesh)[0]
    with mesh:
        jopt = JO.adamw_init(jp, jt.optimizer)
        jp2, jopt2, jm = jax.jit(jstep)(jp, jopt, jbatch)
    tp2, topt2, tm = TL.make_train_step(tcfg, tt)(
        tp, TO.adamw_init(tp, tt.optimizer), tbatch)

    assert set(tm) == set(jm) == {"loss", "aux", "grad_norm"}
    for key in ("loss", "grad_norm", "aux"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **F32)
    assert int(topt2["step"]) == int(jopt2["step"]) == 1
    # m = 0.1 * clipped gradient: the gradients' tolerance, scaled
    for key in ("m", "v"):
        want = params_from_numpy(_to_numpy(jopt2[key]), tcfg, device="cpu")
        _assert_trees_close(topt2[key], want, atol=1e-6, rtol=1e-4)
    ocfg = tt.optimizer
    want = params_from_numpy(_to_numpy(jp2), tcfg, device="cpu")
    n_far = n_all = 0
    for g, w in zip(pytree.tree_leaves(tp2), pytree.tree_leaves(want)):
        diff = (g - w).abs()
        n_far += int((diff > 1e-5).sum())
        n_all += diff.numel()
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2 * ocfg.lr,
                                   rtol=0)
    print(f"{arch} microbatches={micro}: {n_far} of {n_all} parameters "
          f"differ by more than 1e-5")
    assert n_far * 100 < n_all, (n_far, n_all)


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-1.3b"])
def test_remat_policies_are_bitwise_equal(arch):
    _, tcfg = _configs(arch)
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    _, tbatch = _batch(tcfg.vocab, 2, 32)
    results = [_loss_and_grads(tp, dataclasses.replace(tcfg, remat=r),
                               tbatch)
               for r in ("none", "nothing_saveable", "dots")]
    for total, _, grads in results[1:]:
        assert torch.equal(total, results[0][0])
        for g, g0 in zip(pytree.tree_leaves(grads),
                         pytree.tree_leaves(results[0][2])):
            assert torch.equal(g, g0)


def _bits(tree):
    return [t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in pytree.tree_leaves(tree)]


def test_non_finite_step_is_skipped():
    """A batch that reaches a non-finite embedding row gives a NaN loss;
    the step leaves parameters and optimizer state as they were, without
    reading anything back to the host."""
    _, tcfg = _configs("yi-6b")
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    _, tbatch = _batch(tcfg.vocab, 2, 16)
    tp["embed"][int(tbatch["tokens"][0, 3])] = float("inf")
    tc = TL.TrainConfig()
    opt = TO.adamw_init(tp, tc.optimizer)
    step = TL.make_train_step(tcfg, tc)
    before = [t.clone() for t in _bits((tp, opt))]
    p2, opt2, m = step(tp, opt, tbatch)
    assert not np.isfinite(float(m["loss"]))
    for a, b in zip(_bits((p2, opt2)), before):
        assert torch.equal(a, b)
    # the same batch without the bad row takes a step
    tp["embed"][int(tbatch["tokens"][0, 3])] = 0.0
    p3, opt3, m = step(tp, opt, tbatch)
    assert np.isfinite(float(m["loss"])) and int(opt3["step"]) == 1
    assert not torch.equal(p3["units"][0][0]["mixer"]["w_q"],
                           tp["units"][0][0]["mixer"]["w_q"])


def test_thirty_steps_lower_the_loss():
    """examples/quickstart.py's check, through the port: reduced yi-6b in
    bfloat16 on SyntheticLM through the prefetching loader."""
    cfg = get_reduced_config("yi-6b")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tc = TL.TrainConfig(optimizer=TO.AdamWConfig(lr=3e-3))
    opt = TO.adamw_init(params, tc.optimizer)
    step = TL.make_train_step(cfg, tc)
    loader = PrefetchingLoader(SyntheticLM(vocab=cfg.vocab, seq_len=64,
                                           batch=8, n_shards=64), n_steps=30)
    losses = []
    for batch in loader:
        params, opt, m = step(params, opt, TL.batch_to_device(batch, "cpu"))
        losses.append(float(m["loss"]))
    loader.close()
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert loader.stats["pushed_hits"] > loader.stats["misses"]


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "musicgen-large",
                                  "paligemma-3b"])
def test_launcher_trains_moe_prefix_and_codebook_models_on_the_cpu(arch):
    """``launch/train.py`` feeds codebook batches (``SyntheticLM``'s
    codebooks) and zero prefix embeddings; losses stay finite."""
    from repro_torch.launch import train as launch_train
    _, _, history = launch_train.main(
        ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16"])
    assert history and all(np.isfinite(m["loss"]) for _, m in history)


def test_train_loop_refuses_a_mesh_in_data_iters_place():
    """``repro``'s ``train_loop(cfg, tcfg, mesh, data_iter, ...)`` called
    positionally hands the port a mesh as ``data_iter``: a ``TypeError``
    that names the keyword, before anything is built."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    started = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    try:
        cfg = get_reduced_config("yi-6b")
        with pytest.raises(TypeError, match="mesh="):
            TL.train_loop(cfg, TL.TrainConfig(), mesh, iter([]), 1,
                          device="cpu")
    finally:
        if started:
            dist.destroy_process_group()
