"""Serving launcher: greedy decode against a selected architecture with the
HPM-scheduled engine, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --reduced --device cpu [--requests 12]

Traffic: three recurring clients in turn, one request every 20 s of
simulated time, each client always sending the same prompt (with codebooks,
a new random prompt from ``default_rng(0)`` each time).  Weights are random,
drawn from seed 0; the modality stubs' prefix embeddings are zeros.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(gen, cfg, device)
    engine = ServeEngine(cfg, params,
                         max_len=args.prompt_len + args.max_new + 8,
                         device=device)
    rng = np.random.default_rng(0)
    now = 0.0
    lat = []
    for i in range(args.requests):
        client = i % 3                      # 3 recurring clients
        if cfg.codebooks > 1:
            prompt = rng.integers(0, cfg.vocab,
                                  size=(args.prompt_len, cfg.codebooks))
        else:
            prompt = (np.arange(args.prompt_len) * (client + 3)) % cfg.vocab
        t0 = time.monotonic()
        comp = engine.serve(Request(i, client, now, prompt, args.max_new),
                            now)
        lat.append(time.monotonic() - t0)
        print(f"req {i} client {client}: prewarmed={comp.prefetched} "
              f"{len(comp.tokens)} tokens in {lat[-1]*1e3:.0f} ms")
        now += 20.0
    print(f"served {engine.stats['total']} "
          f"(prewarmed {engine.stats['prefetched_prefills']}); "
          f"mean latency {np.mean(lat)*1e3:.0f} ms")
    return engine


if __name__ == "__main__":
    main()
