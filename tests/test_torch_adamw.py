"""The port's AdamW update on the CPU: the in-place ``adamw_update_``
against the functional ``adamw_update`` (bit for bit), both against the
JAX package's ``adamw_update``, the NaN-skip, ``TrainProgram``'s in-place
step, the table that K5 (``kernels/adamw.py``) launches over, and K5's
plain version split at its norm's reduction for a mesh (with no group, the
unsplit version bit for bit; rows left out of the norm).

On the CPU both updates run K5's plain version, so the in-place and
functional forms must agree bit for bit.  Against ``repro`` the
tolerances are ``tests/test_torch_train.py``'s for AdamW: 1e-6 relative
(the same float32 operations element by element), and 1e-7 absolute
where the step cancels a parameter.  Inputs are drawn with NumPy from
seeds.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.train import optimizer as JO
from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import adamw as K5
from repro_torch.models import transformer as TT
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as TO

# sizes 1, 7 and 1000003 (ragged against every vector width and chunk);
# "embed" and the units' vector decay, "final_norm" and "s" do not
SHAPES = {"embed": (7, 1), "final_norm": (7,), "s": (),
          "units": [[{"scale": (1000003,)}]]}


def _draw(rng, shapes, dtype, f=lambda a: a):
    return pytree.tree_map(
        lambda sh: torch.from_numpy(np.asarray(f(np.asarray(
            rng.normal(size=sh), np.float32)), np.float32)).to(dtype),
        shapes, is_leaf=lambda x: isinstance(x, tuple))


def _inputs(seed, p_dtype, g_dtype, m_dtype, grad_scale):
    rng = np.random.default_rng(seed)
    params = _draw(rng, SHAPES, p_dtype)
    grads = _draw(rng, SHAPES, g_dtype, lambda a: grad_scale * a)
    state = {"m": _draw(rng, SHAPES, m_dtype, lambda a: 0.1 * a),
             "v": _draw(rng, SHAPES, m_dtype, lambda a: 0.01 * np.abs(a)),
             "step": torch.tensor(3, dtype=torch.int32)}
    return grads, state, params


def _bits(tree):
    return [t.reshape(-1).view(torch.uint8)
            for t in pytree.tree_leaves(tree)]


def _clone(tree):
    return pytree.tree_map(torch.clone, tree)


def _assert_bitwise(a, b):
    la, lb = _bits(a), _bits(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _norm(grads) -> float:
    return float(np.sqrt(sum(np.sum(np.square(g.double().numpy()))
                             for g in pytree.tree_leaves(grads))))


@pytest.mark.parametrize("clip", ["clipped", "unclipped"])
@pytest.mark.parametrize("p_dtype,g_dtype,m_dtype", [
    (torch.float32, torch.float32, torch.float32),
    (torch.float32, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.float32, torch.bfloat16)],
    ids=["f32-f32-f32", "f32-f32-bf16m", "bf16-bf16-f32m", "bf16-bf16-bf16m",
         "bf16-f32g-f32m", "bf16-f32g-bf16m"])
def test_in_place_equals_functional_bitwise(p_dtype, g_dtype, m_dtype, clip):
    """``adamw_update_`` writes what ``adamw_update`` returns, bit for bit,
    and the functional form leaves its inputs as they were; the decay flags
    are ``_decays``' (stacked unit vectors decay, outer vectors do not)."""
    # 1e-3 * N(0, 1) over ~1e6 entries: norm ~1 either side of grad_clip
    scale = 1e-2 if clip == "clipped" else 1e-4
    grads, state, params = _inputs(0, p_dtype, g_dtype, m_dtype, scale)
    assert (_norm(grads) > 1.0) == (clip == "clipped")
    cfg = TO.AdamWConfig(lr=1e-2)
    loss = torch.tensor(2.5)
    before = _clone((grads, state, params))
    new_params, new_state, gnorm = TO.adamw_update(grads, state, params, cfg,
                                                   loss=loss)
    _assert_bitwise((grads, state, params), before)
    p2, s2 = _clone(params), _clone(state)
    ptrs = [t.data_ptr() for t in pytree.tree_leaves((p2, s2))]
    gnorm2 = TO.adamw_update_(grads, s2, p2, cfg, loss=loss)
    assert [t.data_ptr() for t in pytree.tree_leaves((p2, s2))] == ptrs
    _assert_bitwise((p2, s2), (new_params, new_state))
    assert torch.equal(gnorm, gnorm2)
    assert int(s2["step"]) == 4
    for t, b in zip(pytree.tree_leaves((p2, s2)),
                    pytree.tree_leaves((before[2], before[1]))):
        assert t.dtype == b.dtype
    # the decay rule: between weight decay 10 and 0 only the decayed
    # tensors differ
    decayed = {}
    for wd in (10.0, 0.0):
        decayed[wd] = _clone(params)
        TO.adamw_update_(grads, _clone(state), decayed[wd],
                         TO.AdamWConfig(lr=1e-2, weight_decay=wd), loss=loss)
    same = [torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(decayed[10.0]), pytree.tree_leaves(decayed[0.0]))]
    # leaves: embed, final_norm, s, the unit's scale
    assert same == [False, True, True, False]


def _unsplit_plain_(grads, params, ms, vs, step, decays, *, lr, b1, b2, eps,
                    weight_decay, grad_clip, loss):
    """K5's plain version as it was before its norm was split at the
    reduction (one sum of per-tensor sums, no partial, no group)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    scale = K5.clip_scale(gnorm, grad_clip)
    new_step, c1, c2 = K5.bias_corrections(step, b1, b2)
    ok = torch.isfinite(gnorm) & torch.isfinite(loss)
    for i, (g, p, m, v) in enumerate(zip(grads, params, ms, vs)):
        new = K5.update_tensor(g, m, v, p, decays[i], scale, c1, c2, lr=lr,
                               b1=b1, b2=b2, eps=eps,
                               weight_decay=weight_decay)
        for d, n in zip((p, m, v), new):
            d.copy_(torch.where(ok, n, d))
    step.copy_(torch.where(ok, new_step, step))
    return gnorm


@pytest.mark.parametrize("form", ["defaults", "every_row_no_group"])
@pytest.mark.parametrize("clip", ["clipped", "unclipped"])
@pytest.mark.parametrize("p_dtype,g_dtype,m_dtype", [
    (torch.float32, torch.float32, torch.float32),
    (torch.float32, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.float32, torch.bfloat16)],
    ids=["f32-f32-f32", "f32-f32-bf16m", "bf16-bf16-f32m", "bf16-bf16-bf16m",
         "bf16-f32g-f32m", "bf16-f32g-bf16m"])
def test_split_plain_without_a_group_equals_unsplit_bitwise(
        p_dtype, g_dtype, m_dtype, clip, form):
    """The plain version split at the norm's reduction (this rank's
    partial, the group's sum, the rest), given no group and every tensor
    counted, is the unsplit version bit for bit: norm, parameters,
    moments and step."""
    scale = 1e-2 if clip == "clipped" else 1e-4
    grads, state, params = _inputs(0, p_dtype, g_dtype, m_dtype, scale)
    gs, ps, ms, vs, decays, _ = TO._flat(grads, state, params)
    hyper = TO._hyper(TO.AdamWConfig(lr=1e-2))
    loss = torch.tensor(2.5)
    want_state = _clone((ps, ms, vs, state["step"]))
    want = _unsplit_plain_(gs, *want_state, decays, loss=loss, **hyper)
    extra = {} if form == "defaults" else {"counted": [True] * len(ps),
                                           "groups": []}
    got = K5.adamw_step_plain_(gs, ps, ms, vs, state["step"], decays,
                               loss=loss, **extra, **hyper)
    assert (float(want) > 1.0) == (clip == "clipped")
    assert torch.equal(got, want)
    _assert_bitwise((ps, ms, vs, state["step"]), want_state)


def test_norm_flags_leave_rows_out_of_the_norm():
    """A tensor flagged not counted (a replicated shard on a rank past
    coordinate 0) leaves the norm: it is the counted tensors' norm, and
    the uncounted tensor is still updated.  The flag is its own bit of the
    row code, does not move the row in the table, and keys the table
    cache."""
    grads, state, params = _inputs(3, torch.float32, torch.float32,
                                   torch.float32, 1e-3)
    gs, ps, ms, vs, decays, _ = TO._flat(grads, state, params)
    hyper = TO._hyper(TO.AdamWConfig(lr=1e-2))
    counted = [True, False, True, True]
    before = _clone(ps)
    got = K5.adamw_step_plain_(gs, ps, ms, vs, state["step"], decays,
                               counted=counted, **hyper)
    want = K5.grad_norm([g for g, c in zip(gs, counted) if c])
    assert torch.equal(got, want) and float(got) < float(K5.grad_norm(gs))
    assert not torch.equal(ps[1], before[1])
    none = K5.adamw_step_plain_(gs, _clone(ps), _clone(ms), _clone(vs),
                                state["step"].clone(), decays,
                                counted=[False] * 4, **hyper)
    assert float(none) == 0.0
    f32 = torch.float32
    assert K5.code(f32, f32, f32, True, counted=False) == \
        K5.DECAY | K5.NO_NORM
    assert K5.plan([5, 5, 5], [K5.NO_NORM | K5.P_BF16, 0, K5.NO_NORM]) == \
        K5.plan([5, 5, 5], [K5.P_BF16, 0, 0])
    assert K5._key(gs, ps, ms, vs, decays, counted) != \
        K5._key(gs, ps, ms, vs, decays)


@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clipped", "unclipped"])
def test_in_place_matches_repro(clip):
    """In place, float32, against the JAX package's functional update at
    ``test_torch_train.py``'s AdamW tolerances (its layout has no units:
    ndim >= 2 decays in both): 1e-6 relative, and 1e-7 absolute where the
    step cancels a parameter (one float32 ulp of the operands, below ~1;
    a few of the million entries here)."""
    shapes = {"w": (1000003, 1), "b": (7,), "s": (), "one": (1,)}
    rng = np.random.default_rng(1)
    params, grads, m, v = (_draw(rng, shapes, torch.float32, f) for f in (
        lambda a: a, lambda a: 3e-3 * a, lambda a: 0.1 * a,
        lambda a: 0.01 * np.abs(a)))

    def j(tree):
        # copies: JAX on the CPU may alias a NumPy buffer, and computes
        # after this returns, when the in-place update below has written it
        return {k: jnp.array(a.numpy()) for k, a in tree.items()}
    jout = JO.adamw_update(j(grads), {"m": j(m), "v": j(v),
                                      "step": jnp.int32(4)}, j(params),
                           JO.AdamWConfig(lr=1e-2, grad_clip=clip))
    state = {"m": m, "v": v, "step": torch.tensor(4, dtype=torch.int32)}
    gnorm = TO.adamw_update_(grads, state, params,
                             TO.AdamWConfig(lr=1e-2, grad_clip=clip))
    np.testing.assert_allclose(float(gnorm), float(jout[2]), rtol=1e-6)
    assert int(state["step"]) == int(jout[1]["step"]) == 5
    for got, want in ((params, jout[0]), (state["m"], jout[1]["m"]),
                      (state["v"], jout[1]["v"])):
        for k in shapes:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bad", ["nan_grad", "inf_grad", "nan_loss",
                                 "inf_loss"])
@pytest.mark.parametrize("form", ["in_place", "functional"])
def test_non_finite_step_changes_nothing(bad, form):
    """A non-finite gradient or loss: parameters, moments and ``step``
    stay bitwise as they were (functional: the outputs equal the
    inputs)."""
    grads, state, params = _inputs(2, torch.bfloat16, torch.bfloat16,
                                   torch.float32, 1e-3)
    loss = torch.tensor(1.0)
    if bad.endswith("grad"):
        grads["units"][0][0]["scale"][12345] = float(
            "nan" if bad == "nan_grad" else "inf")
    else:
        loss = torch.tensor(float("nan" if bad == "nan_loss" else "inf"))
    before = _clone((params, state))
    cfg = TO.AdamWConfig()
    if form == "in_place":
        gnorm = TO.adamw_update_(grads, state, params, cfg, loss=loss)
        after = (params, state)
    else:
        new_p, new_s, gnorm = TO.adamw_update(grads, state, params, cfg,
                                              loss=loss)
        after = (new_p, new_s)
    _assert_bitwise(after, before)
    assert int(after[1]["step"]) == 3
    assert bool(torch.isfinite(gnorm)) == bad.endswith("loss")


@pytest.mark.parametrize("arch,micro", [("yi-6b", 1), ("mamba2-1.3b", 1),
                                        ("yi-6b", 2)])
def test_train_program_updates_in_place_as_step_fn(arch, micro):
    """A CPU ``TrainProgram`` (``step_fn.in_place``) keeps every state
    tensor's storage and, over two steps, equals ``step_fn``'s functional
    steps bit for bit: parameters, moments, step and metrics."""
    cfg = get_reduced_config(arch)
    tcfg = TL.TrainConfig(microbatches=micro)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, n_shards=4)
    batches = [TL.batch_to_device(src.batch_from_shard(src.load_shard(i)),
                                  "cpu") for i in range(2)]
    params = TT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = TO.adamw_init(params, tcfg.optimizer)
    step = TL.make_train_step(cfg, tcfg)
    p, o = _clone(params), _clone(opt)
    program = TL.TrainProgram(step, params, opt, batches[0])
    ptrs = [t.data_ptr() for t in pytree.tree_leaves((params, opt))]
    for b in batches:
        got = program.step(b)
        p, o, want = step(p, o, b)
        for k in ("loss", "grad_norm"):
            assert torch.equal(got[k], want[k])
    assert [t.data_ptr() for t in pytree.tree_leaves((params, opt))] == ptrs
    assert int(opt["step"]) == 2
    _assert_bitwise((params, opt), (p, o))


def test_train_program_refuses_a_step_without_an_in_place_form():
    """``TrainProgram`` runs ``step_fn.in_place`` only; a functional step
    function without one (``make_train_step`` on a mesh) is refused when
    the program is built, not copied back step by step."""
    cfg = get_reduced_config("yi-6b")
    tcfg = TL.TrainConfig()
    src = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, n_shards=4)
    batch = TL.batch_to_device(src.batch_from_shard(src.load_shard(0)),
                               "cpu")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = TO.adamw_init(params, tcfg.optimizer)
    step = TL.make_train_step(cfg, tcfg)
    with pytest.raises(TypeError):
        TL.TrainProgram(lambda *a: step(*a), params, opt, batch)


def test_table_covers_every_element_once_grouped_by_dtype():
    """``plan`` orders the rows by dtype code (stable within a code), and
    the chunks that ``chunk_range`` (the kernel's binary search) hands out
    tile every tensor exactly once; tensors without elements get none."""
    rng = np.random.default_rng(4)
    c = K5.CHUNK
    numels = [0, 1, 7, c - 1, c, c + 1, 3 * c + 5, 1000003, 0, 2]
    numels += [int(n) for n in rng.integers(1, 5 * c, size=30)]
    codes = [int(k) | (K5.DECAY if rng.random() < 0.5 else 0)
             for k in rng.integers(0, 8, size=len(numels))]
    order, prefix = K5.plan(numels, codes)
    assert sorted(order) == list(range(len(numels)))
    kinds = [codes[i] & 7 for i in order]
    assert kinds == sorted(kinds)
    for k in set(kinds):
        same = [i for i in order if codes[i] & 7 == k]
        assert same == sorted(same)
    in_order = [numels[i] for i in order]
    covered = [np.zeros(n, np.int32) for n in in_order]
    for chunk in range(prefix[-1]):
        r, s, e = K5.chunk_range(prefix, in_order, chunk)
        assert 0 <= s < e <= in_order[r] and e - s <= c
        covered[r][s:e] += 1
    assert all((cv == 1).all() for cv in covered)
    assert K5.code(torch.bfloat16, torch.float32, torch.bfloat16, True) == \
        K5.P_BF16 | K5.M_BF16 | K5.DECAY


def test_wrapper_refuses_what_it_cannot_take():
    """Mismatched counts raise on any device; a tensor on a device other
    than the CPU or CUDA raises rather than falling back."""
    g = [torch.ones(3)]
    p = [torch.ones(3)]
    step = torch.zeros((), dtype=torch.int32)
    hyper = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 grad_clip=1.0)
    with pytest.raises(ValueError):
        K5.adamw_step_(g, p, [], [], step, [True], **hyper)
    meta = [torch.ones(3, device="meta")]
    with pytest.raises(ValueError):
        K5.adamw_step_(meta, meta, meta, meta, step, [True], **hyper)
