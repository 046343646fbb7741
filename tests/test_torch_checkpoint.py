"""The port's checkpoints, on the CPU: ``test_substrate.py``'s five
checkpoint cases, the on-disk layout, a bitwise bfloat16 round trip, and a
``train_loop`` resume equal to restoring by hand and stepping the same
batches.  No JAX: the layout is the JAX package's, but each package reads
its own checkpoints."""
import json
import os

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.models.transformer import init_params
from repro_torch.train.loop import (TrainConfig, batch_to_device,
                                    make_train_step, train_loop)
from repro_torch.train.optimizer import adamw_init


def test_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4))}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(tree, step=5, blocking=True)
    out, step = mgr.restore_latest(tree)
    assert step == 5
    np.testing.assert_array_equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"]["c"], tree["b"]["c"])


def test_resume_latest_of_many(tmp_path):
    tree = {"x": torch.zeros(4)}
    mgr = CheckpointManager(str(tmp_path))
    for s in (10, 20, 30):
        mgr.save({"x": torch.full((4,), float(s))}, step=s, blocking=True)
    out, step = mgr.restore_latest(tree)
    assert step == 30
    assert float(out["x"][0]) == 30.0


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save({"x": torch.zeros(2)}, step=s, blocking=True)
    assert mgr.steps() == [3, 4]


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"x": torch.zeros(2)}, step=1, blocking=True)
    # a directory without manifest == crashed mid-write
    os.makedirs(tmp_path / "step_9", exist_ok=True)
    out, step = mgr.restore_latest({"x": torch.zeros(2)})
    assert step == 1


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.ones(8)
    mgr.save({"x": x}, step=2, blocking=False)
    x.zero_()               # the snapshot was taken before save returned
    mgr.wait()
    assert mgr.steps() == [2]
    assert float(mgr.restore({"x": x}, 2)["x"].sum()) == 8.0


def test_layout_names_and_bfloat16_bitwise(tmp_path):
    """``step_<N>/shard_0.npz`` plus ``manifest.json``; names from the
    dict/list paths; bfloat16 stored as its bit patterns and restored bit
    for bit (NaN, infinities, signed zero and subnormals included)."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    tree = ({"w": [bits.view(torch.bfloat16).reshape(256, 256),
                   torch.randn(3, dtype=torch.float32)]},
            {"step": torch.tensor(7, dtype=torch.int32)})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(tree, step=3, blocking=True)
    assert sorted(os.listdir(tmp_path / "step_3")) == ["manifest.json",
                                                       "shard_0.npz"]
    with open(tmp_path / "step_3" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["names"] == ["0/w/0", "0/w/1", "1/step"]
    assert manifest["dtypes"] == ["bfloat16", "float32", "int32"]
    assert manifest["shapes"] == [[256, 256], [3], []]
    template = pytree.tree_map(torch.zeros_like, tree)
    out = mgr.restore(template, 3)
    assert out[0]["w"][0].dtype == torch.bfloat16
    assert torch.equal(out[0]["w"][0].view(torch.int16),
                       tree[0]["w"][0].view(torch.int16))
    assert torch.equal(out[0]["w"][1], tree[0]["w"][1])
    assert int(out[1]["step"]) == 7 and out[1]["step"].dtype == torch.int32


def _data(cfg, n):
    src = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=2, n_shards=8)
    return iter([src.batch_from_shard(src.load_shard(i)) for i in range(n)])


def _bits(tree):
    return [t.view(torch.int16) if t.dtype == torch.bfloat16
            else t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in pytree.tree_leaves(tree)]


def test_train_loop_resume_equals_restore_by_hand(tmp_path):
    """Train 2 steps and checkpoint; a second run resumes from step 2 and
    trains to 4 on a data iterator that starts over (the JAX package does
    not restore the data position either).  Restoring step 2 by hand and
    stepping the iterator's first two batches gives the same bits."""
    cfg = get_reduced_config("yi-6b")
    tcfg = TrainConfig(checkpoint_every=2)
    ckpt = str(tmp_path / "ckpt")
    train_loop(cfg, tcfg, _data(cfg, 3), 2, checkpoint_dir=ckpt,
               device="cpu")
    assert CheckpointManager(ckpt).steps() == [2]
    params, opt, _ = train_loop(cfg, tcfg, _data(cfg, 3), 4,
                                checkpoint_dir=ckpt, device="cpu")
    assert CheckpointManager(ckpt).steps() == [2, 4]

    template = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    template = (template, adamw_init(template, tcfg.optimizer))
    p, o = CheckpointManager(ckpt).restore(template, 2)
    assert int(o["step"]) == 2
    step = make_train_step(cfg, tcfg)
    for batch in list(_data(cfg, 2)):
        p, o, _ = step(p, o, batch_to_device(batch, "cpu"))
    assert int(opt["step"]) == int(o["step"]) == 4
    for a, b in zip(_bits((params, opt)), _bits((p, o))):
        assert torch.equal(a, b)
    # and the final checkpoint holds exactly that state
    for a, b in zip(_bits(CheckpointManager(ckpt).restore(template, 4)),
                    _bits((p, o))):
        assert torch.equal(a, b)
