"""K3's backward on the CPU: ``ssd_scan_backward_plain`` (the oracle the
backward kernel is held against on the card) against ``jax.vjp`` of the
JAX package's ``ssd_chunked`` and against torch autograd of the port's
``ssd_chunked``, on its own recomputed states and on the kernel's path
(incoming states saved by the forward at its chunk, advanced inside it),
and the train loop's ``TrainProgram`` on the CPU.

Inputs are made with NumPy from a seed and handed to both packages.  The
references run at chunk 32 on inputs padded to a chunk multiple with
dt = 0 (as the model pads), and their gradients are cut back to S; the
plain backward takes any S.  Tolerances, relative L2 per gradient:
float32 1e-5 (the same float32 algebra, summed in other orders), but 3e-5
for ``dA``, a sum over every position of dt times a reverse cumsum of
cancelling terms (the plain version and both references each land up to
~1.3e-5 from a float64 autograd on these inputs); bfloat16 inputs 2e-2
against the float32 references on the same rounded values (``dx``,
``dB``, ``dC`` come back in bfloat16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.models import mamba as jmamba
from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as K3
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as TT
from repro_torch.train import loop as TL
from repro_torch.train.optimizer import adamw_init

CHUNK = 32
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DA_TOL_F32 = 3e-5
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(seed, bt, s, h, p, g, n, dtype, with_final):
    """x, dt, A, B, C, dy, dfinal as float32 NumPy arrays, x/B/C/dy
    already rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    out = {
        "x": rng.normal(size=(bt, s, h, p)),
        "dt": np.log1p(np.exp(rng.normal(size=(bt, s, h)))),
        "A": -np.exp(rng.normal(size=(h,)) * 0.5),
        "B": rng.normal(size=(bt, s, g, n)),
        "C": rng.normal(size=(bt, s, g, n)),
        "dy": rng.normal(size=(bt, s, h, p)),
        "dfinal": (rng.normal(size=(bt, h, n, p)) if with_final
                   else np.zeros((bt, h, n, p))),
    }
    out = {k: v.astype(np.float32) for k, v in out.items()}
    for k in ("x", "B", "C", "dy"):
        out[k] = torch.from_numpy(out[k]).to(dtype).float().numpy()
    return out


def _padded(a: np.ndarray, s: int) -> np.ndarray:
    pad = (-s) % CHUNK
    return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))


def _jax_grads(a, s):
    ins = [jnp.asarray(_padded(a[k], s)) if k != "A" else jnp.asarray(a[k])
           for k in ("x", "dt", "A", "B", "C")]
    _, vjp = jax.vjp(lambda *t: jmamba.ssd_chunked(*t, CHUNK), *ins)
    grads = vjp((jnp.asarray(_padded(a["dy"], s)), jnp.asarray(a["dfinal"])))
    return [np.asarray(g) if i == 2 else np.asarray(g)[:, :s]
            for i, g in enumerate(grads)]


def _torch_grads(a, s):
    ins = [torch.from_numpy(_padded(a[k], s) if k != "A" else a[k])
           .requires_grad_() for k in ("x", "dt", "A", "B", "C")]
    y, final = tmamba.ssd_chunked(*ins, CHUNK)
    loss = (y * torch.from_numpy(_padded(a["dy"], s))).sum() + \
        (final * torch.from_numpy(a["dfinal"])).sum()
    grads = torch.autograd.grad(loss, ins)
    return [g.numpy() if i == 2 else g.numpy()[:, :s]
            for i, g in enumerate(grads)]


def _plain_grads(a, dtype, with_final):
    def t(k, typ=torch.float32):
        return torch.from_numpy(a[k]).to(typ)
    got = K3.ssd_scan_backward_plain(
        t("x", dtype), t("dt"), t("A"), t("B", dtype), t("C", dtype),
        t("dy", dtype), t("dfinal") if with_final else None)
    assert got[0].dtype == got[3].dtype == got[4].dtype == dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    return [g.float().numpy() for g in got]


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (S, dfinal): a chunk multiple with a zero final cotangent, a ragged S
# (dt = 0 padding in the references) with and without one
LENGTHS = [(128, False), (100, False), (100, True)]


@pytest.mark.parametrize("s,with_final", LENGTHS)
@pytest.mark.parametrize("n,p", [(16, 16), (64, 64)])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_backward_matches_jax_vjp_and_torch_autograd(dtype, g, n, p, s,
                                                           with_final):
    a = _inputs(s + 7 * g + n, 2, s, 4, p, g, n, dtype, with_final)
    got = _plain_grads(a, dtype, with_final)
    for ref, want in (("jax.vjp", _jax_grads(a, s)),
                      ("autograd", _torch_grads(a, s))):
        for name, x, w in zip(NAMES, got, want):
            assert x.shape == w.shape, (ref, name)
            err = _rel_l2(x, w)
            tol = DA_TOL_F32 if (name == "dA" and dtype == torch.float32) \
                else TOL[dtype]
            assert err <= tol, (ref, name, err)


def _plain_grads_from_states(a, dtype, with_final, chunk, states_chunk):
    """The plain backward on the kernel's path: the incoming states taken
    from ``ssd_scan_plain``'s at ``states_chunk`` (the forward's chunk),
    each chunk inside one advanced from it."""
    def t(k, typ=torch.float32):
        return torch.from_numpy(a[k]).to(typ)
    ins = (t("x", dtype), t("dt"), t("A"), t("B", dtype), t("C", dtype))
    _, _, states = K3.ssd_scan_plain(*ins, keep_states=True,
                                     chunk=states_chunk)
    got = K3.ssd_scan_backward_plain(
        *ins, t("dy", dtype), t("dfinal") if with_final else None,
        chunk=chunk, states=states, states_chunk=states_chunk)
    return [g.float().numpy() for g in got]


# (backward chunk, forward chunk): bf16's 64 in 128 and float32's at
# N = P = 128, 32 in 64 (a chunk that is a forward chunk's second half
# advances the saved state), and equal chunks; S = 300 and 100 are
# multiples of neither
STATE_CHUNKS = [(64, 128), (32, 64), (64, 64)]


@pytest.mark.parametrize("s,with_final", [(300, False), (100, True)])
@pytest.mark.parametrize("chunk,states_chunk", STATE_CHUNKS)
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_backward_from_saved_states_matches_jax_vjp_and_recompute(
        dtype, g, chunk, states_chunk, s, with_final):
    a = _inputs(s + 11 * g + chunk, 2, s, 4, 16, g, 16, dtype, with_final)
    got = _plain_grads_from_states(a, dtype, with_final, chunk, states_chunk)
    for ref, want in (("jax.vjp", _jax_grads(a, s)),
                      ("recompute", _plain_grads(a, dtype, with_final))):
        for name, x, w in zip(NAMES, got, want):
            assert x.shape == w.shape, (ref, name)
            err = _rel_l2(x, w)
            tol = DA_TOL_F32 if (name == "dA" and dtype == torch.float32) \
                else TOL[dtype]
            assert err <= tol, (ref, name, err)


def test_plain_scan_keeps_the_state_entering_each_chunk():
    """``ssd_scan_plain(..., keep_states=True, chunk=k)``'s third output:
    slot c is the final state of the scan over the first c k positions,
    bit for bit (zero for c = 0), at an S that is no multiple of k."""
    a = _inputs(8, 2, 90, 4, 16, 2, 16, torch.float32, False)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    ins = [t[k] for k in ("x", "dt", "A", "B", "C")]
    y, final, states = K3.ssd_scan_plain(*ins, keep_states=True, chunk=32)
    assert states.shape == (2, 3, 4, 16, 16)
    assert torch.equal(states[:, 0], torch.zeros_like(final))
    for c in (1, 2):
        head = [v[:, :32 * c] if v.dim() > 1 else v for v in ins]
        assert torch.equal(states[:, c], K3.ssd_scan_plain(*head)[1])
    wy, wfinal = K3.ssd_scan_plain(*ins)
    assert torch.equal(y, wy) and torch.equal(final, wfinal)


def test_plain_backward_refuses_states_at_another_chunk():
    a = _inputs(9, 1, 64, 2, 16, 1, 16, torch.float32, True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    ins = [t[k] for k in ("x", "dt", "A", "B", "C")]
    _, _, states = K3.ssd_scan_plain(*ins, keep_states=True, chunk=32)
    for chunk, states_chunk in ((64, 32), (32, 48), (32, None)):
        with pytest.raises(ValueError, match="states"):
            K3.ssd_scan_backward_plain(*ins, t["dy"], t["dfinal"],
                                       chunk=chunk, states=states,
                                       states_chunk=states_chunk)


@pytest.mark.parametrize("chunk", [16, 64])
def test_plain_backward_does_not_depend_on_its_chunk(chunk):
    """Chunking is exact: the plain backward at another chunk length gives
    the same gradients to float32 rounding."""
    a = _inputs(3, 1, 100, 4, 16, 2, 16, torch.float32, True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    args = [t[k] for k in ("x", "dt", "A", "B", "C", "dy", "dfinal")]
    want = K3.ssd_scan_backward_plain(*args, chunk=32)
    got = K3.ssd_scan_backward_plain(*args, chunk=chunk)
    for name, x, w in zip(NAMES, got, want):
        assert _rel_l2(x.numpy(), w.numpy()) <= 1e-5, name


def test_cpu_wrapper_is_the_plain_backward():
    a = _inputs(4, 1, 40, 2, 16, 1, 16, torch.float32, True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    args = [t[k] for k in ("x", "dt", "A", "B", "C", "dy", "dfinal")]
    K3.reset_counts()
    for x, w in zip(K3.ssd_scan_backward(*args),
                    K3.ssd_scan_backward_plain(*args)):
        assert torch.equal(x, w)
    assert K3.BWD_LAUNCHES == 0


def test_cpu_forward_keeps_no_states():
    """On the CPU the forward keeps no chunk states (None: its backward
    recomputes them), and y and the final state are the call's without
    them."""
    a = _inputs(10, 1, 70, 2, 16, 1, 16, torch.float32, True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    ins = [t[k] for k in ("x", "dt", "A", "B", "C")]
    y, final, kept = K3.ssd_scan(*ins, keep_states=True)
    assert kept is None
    assert all(torch.equal(u, v) for u, v in zip((y, final),
                                                  K3.ssd_scan(*ins)))


def test_cpu_ssd_scan_differentiates_ssd_chunked():
    """On the CPU the models' SSD entry stays the plain chunked path under
    autograd: the same gradients, bit for bit, as ``ssd_chunked``'s."""
    a = _inputs(5, 1, 64, 2, 16, 1, 16, torch.float32, True)
    grads = []
    for fn in (lambda *t: ops.ssd_scan(*t, chunk_size=CHUNK),
               lambda *t: tmamba.ssd_chunked(*t, CHUNK)):
        ins = [torch.from_numpy(a[k]).requires_grad_()
               for k in ("x", "dt", "A", "B", "C")]
        y, final = fn(*ins)
        loss = (y * torch.from_numpy(a["dy"])).sum() + \
            (final * torch.from_numpy(a["dfinal"])).sum()
        grads.append(torch.autograd.grad(loss, ins))
    for x, w in zip(*grads):
        assert torch.equal(x, w)


def _bits(tree):
    return [t.view(torch.uint8) if t.dim() else t
            for t in pytree.tree_leaves(tree)]


def test_train_program_on_the_cpu_equals_make_train_step_bitwise():
    """``train_loop`` on the CPU steps a ``TrainProgram`` eagerly (no
    graph), updating the parameters and moments in place: three steps of
    reduced mamba2-1.3b equal three ``make_train_step`` calls bit for
    bit, losses included."""
    cfg = get_reduced_config("mamba2-1.3b")
    tcfg = TL.TrainConfig(log_every=1)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=2, n_shards=8)
    batches = [src.batch_from_shard(src.load_shard(i)) for i in range(4)]
    hist = []
    params, opt, _ = TL.train_loop(cfg, tcfg, iter(batches), 3,
                                   device="cpu",
                                   log_fn=lambda s, m: hist.append(m))
    p = TT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    o = adamw_init(p, tcfg.optimizer)
    step = TL.make_train_step(cfg, tcfg)
    losses = []
    for b in batches[:3]:
        p, o, m = step(p, o, TL.batch_to_device(b, "cpu"))
        losses.append(float(m["loss"]))
    assert [m["loss"] for m in hist] == losses
    assert int(opt["step"]) == 3
    for x, w in zip(_bits((params, opt)), _bits((p, o))):
        assert torch.equal(x, w)


def test_train_program_updates_its_state_in_place_and_refuses_a_new_layout():
    cfg = dataclasses.replace(get_reduced_config("mamba2-1.3b"), n_layers=2)
    tcfg = TL.TrainConfig()
    p = TT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    o = adamw_init(p, tcfg.optimizer)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=2, n_shards=4)
    batch = TL.batch_to_device(src.batch_from_shard(src.load_shard(0)), "cpu")
    program = TL.TrainProgram(TL.make_train_step(cfg, tcfg), p, o, batch)
    before = [t.clone() for t in pytree.tree_leaves(p)]
    ptrs = [t.data_ptr() for t in pytree.tree_leaves((p, o))]
    metrics = program.step(batch)
    assert program.graph is None and torch.isfinite(metrics["loss"])
    assert [t.data_ptr() for t in pytree.tree_leaves((p, o))] == ptrs
    assert int(o["step"]) == 1
    assert any(not torch.equal(a, b)
               for a, b in zip(before, pytree.tree_leaves(p)))
    wider = {k: torch.cat([v, v], dim=1) for k, v in batch.items()}
    with pytest.raises(ValueError, match="layout"):
        program.step(wider)
