"""Training launcher, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        [--reduced] [--steps 50] [--batch 4] [--seq 128] [--ckpt-dir DIR] \
        [--microbatches 1] [--device cuda|cpu] \
        [--mesh none|auto|single|multi]

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch yi-6b \
        --reduced --mesh auto

Random initial parameters (seed 0), ``SyntheticLM`` data (one stream per
codebook where the model has codebooks) through the push-prefetching
loader, zero prefix embeddings for the modality stubs, checkpoint/restart
(``--ckpt-dir``), NaN-step skipping.

``--mesh``: ``none`` (the default) trains on one device without
shardings; ``auto`` builds the largest (data, model) mesh over the world
size ``torchrun`` sets (``remesh``; one process is a 1 × 1 mesh), NCCL on
the card and gloo with ``--device cpu``; ``single`` and ``multi`` are the
production (16, 16) and (2, 16, 16) meshes, which need 256 and 512 ranks.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import PrefetchingLoader, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.elastic import remesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train.loop import TrainConfig, train_loop


def _mesh(kind: str, device: torch.device):
    """The mesh ``--mesh`` names, over the process group ``torchrun``
    describes in the environment (started here when it is not yet)."""
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if kind == "auto":
        world = dist.get_world_size() if dist.is_initialized() else 1
        return remesh(model_parallel=min(16, world),
                      device_type=device.type)
    return make_production_mesh(multi_pod=kind == "multi",
                                device_type=device.type)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mesh", default="none",
                    choices=("none", "auto", "single", "multi"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = None if args.mesh == "none" else _mesh(args.mesh, device)
    if mesh is not None:
        device = torch.device(device.type, torch.cuda.current_device()) \
            if device.type == "cuda" else device
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}  "
              f"ranks: {mesh.size()}")
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}")

    source = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                         n_shards=512, codebooks=cfg.codebooks)
    loader = PrefetchingLoader(source, n_steps=args.steps + 1)

    def add_prefix(it):
        """The modality stub's prefix embeddings: zeros."""
        for b in it:
            if cfg.n_prefix:
                b = dict(b, prefix_embeddings=torch.zeros(
                    (args.batch, cfg.n_prefix, cfg.d_model), dtype=cfg.dtype))
            yield b

    tcfg = TrainConfig(microbatches=args.microbatches)
    try:
        params, opt_state, history = train_loop(
            cfg, tcfg, add_prefix(iter(loader)), args.steps,
            checkpoint_dir=args.ckpt_dir,
            log_fn=lambda s, m: print(f"step {s}: {m}", flush=True),
            device=device, mesh=mesh)
        print(f"done; pipeline stats: {loader.stats}")
    finally:
        loader.close()
    return params, opt_state, history


if __name__ == "__main__":
    main()
