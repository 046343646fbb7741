#!/usr/bin/env python3
"""Whether the two ways of taking rows of an embedding table give the same
gradient on one card: ``table[ids]`` (the port's lookup, on one device
and, per rank, on a mesh) and ``F.embedding(ids, table)``.  Each sums a
repeated token's row gradients in its own order, so in bfloat16 the sums
may differ in their last bits.  Each way runs twice, to tell its order
from run-to-run noise.

The table has yi-6b's shape (64000 x 4096, bfloat16, random from a seed),
the ids are the first batch of ``chip_smoke.py``'s phase 22 (4 x 2048
tokens of ``SyntheticLM``), and the upstream gradient is random from a
seed.  Prints one JSON line.  Run from the repository root on a machine
with the card:

    python3 scripts/embedding_backward_order.py
"""
from __future__ import annotations

import json
import pathlib
import sys

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.train.loop import batch_to_device  # noqa: E402

VOCAB, D_MODEL, BATCH, SEQ = 64000, 4096, 4, 2048


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    src = SyntheticLM(vocab=VOCAB, seq_len=SEQ, batch=BATCH, n_shards=512)
    ids = batch_to_device(src.batch_from_shard(src.load_shard(0)),
                          dev)["tokens"]
    gen = torch.Generator(device=dev).manual_seed(0)
    table = (torch.randn(VOCAB, D_MODEL, generator=gen, device=dev)
             * 0.02).to(torch.bfloat16)
    up = torch.randn(*ids.shape, D_MODEL, generator=gen,
                     device=dev).to(torch.bfloat16)

    def grad(lookup):
        t = table.detach().requires_grad_()
        (g,) = torch.autograd.grad(lookup(t), t, grad_outputs=up)
        return g

    index = [grad(lambda t: t[ids]) for _ in range(2)]
    embedding = [grad(lambda t: F.embedding(ids, t)) for _ in range(2)]
    diff = (index[0].float() - embedding[0].float()).abs()
    counts = torch.bincount(ids.reshape(-1).long(), minlength=VOCAB)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "tokens": ids.numel(), "repeated_rows": int((counts > 1).sum()),
        "index_run_to_run_bitwise": bool(torch.equal(*index)),
        "embedding_run_to_run_bitwise": bool(torch.equal(*embedding)),
        "index_vs_embedding_bitwise": bool(torch.equal(index[0],
                                                       embedding[0])),
        "rows_that_differ": int((diff.amax(dim=1) > 0).sum()),
        "rows_that_differ_and_repeat": int(
            ((diff.amax(dim=1) > 0) & (counts > 1)).sum()),
        "max_abs_diff": float(diff.max()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
