"""Serving engine: KV-cache prefill/decode with an HPM-scheduled request
stream.

Decode request streams are the paper's *real-time requests*: identical small
requests arriving at high frequency.  The engine

- classifies request streams by their arrival regularity (program ≈
  recurring clients, human ≈ ad-hoc),
- *subscribes* recurring clients (paper §IV-B): their next request's
  prefill is started at ``offset × predicted_gap`` before the predicted
  arrival (prefix caching plays the role of the DTN cache),
- decodes greedily, one request at a time.

Prefill and decode run on the engine's device (CUDA by default, where
prefill goes through the attention and SSD kernels); the scheduler is
host-side control logic whose ARIMA forecasts go through the ARIMA bank
kernel.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.arima import ARIMA, predict_next_timestamp
from repro_torch.device import resolve_device
from repro_torch.models.transformer import ModelConfig, decode_step, prefill


@dataclasses.dataclass
class Request:
    request_id: int
    client_id: int
    arrival: float
    prompt: np.ndarray               # [S] token ids ([S, CB] with codebooks)
    max_new_tokens: int = 16


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: list[int]
    prefill_started: float
    first_token_at: float
    done_at: float
    prefetched: bool                 # prefill began before arrival (pushed)
    served_at: float = 0.0           # when the request reached the engine

    @property
    def ttft(self) -> float:
        """Client-perceived time to first token: prewarmed prefills have
        already run, so only the (fast) cache lookup remains."""
        return self.first_token_at - self.served_at


class ServeEngine:
    """Single-host engine: one request at a time, greedy decoding."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 256,
                 prefetch_offset: float = 0.8, device=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.offset = prefetch_offset
        self.device = resolve_device(device)
        # per-arrival scheduling is latency-sensitive: fit a single series
        # per call, not a padded bank group
        self._sched_arima = ARIMA(bank=False, device=self.device)
        self._client_history: dict[int, list[float]] = {}
        self._prewarmed: dict[int, tuple[Any, int, float]] = {}
        self.stats = {"prefetched_prefills": 0, "total": 0}

    # -- HPM-style scheduling -----------------------------------------------

    def observe_arrival(self, client_id: int, ts: float) -> float | None:
        """Record an arrival; if the client is 'program-like' (≥4 regular
        arrivals), return the time at which to pre-warm the next prefill."""
        h = self._client_history.setdefault(client_id, [])
        h.append(ts)
        if len(h) >= 4:
            gaps = np.diff(np.array(h[-8:]))
            med = np.median(gaps)
            if med > 0 and np.std(gaps) / med < 0.25:
                nxt = predict_next_timestamp(np.array(h[-8:]),
                                             self._sched_arima)
                return ts + self.offset * (nxt - ts)
        return None

    def prewarm(self, client_id: int, prompt: np.ndarray, now: float) -> None:
        """Run the prefill ahead of the predicted request (push-based)."""
        logits, caches, length = self._prefill(prompt)
        self._prewarmed[client_id] = ((logits, caches, length), len(prompt),
                                      time.monotonic())

    def _prefill(self, prompt: np.ndarray):
        """Prompt [S] (or [S, CB]) -> (last logits, caches, length); the
        modality stub's prefix embeddings are zeros."""
        cfg = self.cfg
        tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                                 device=self.device)[None]
        pe = (torch.zeros((1, cfg.n_prefix, cfg.d_model),
                          dtype=torch.bfloat16, device=self.device)
              if cfg.n_prefix else None)
        return prefill(self.params, cfg, tokens, pe,
                       max_len=self.max_len + cfg.n_prefix)

    # -- serving --------------------------------------------------------------

    def serve(self, req: Request, now: float | None = None) -> Completion:
        t_entry = time.monotonic()
        now = t_entry if now is None else now
        self.stats["total"] += 1
        pre = self._prewarmed.pop(req.client_id, None)
        prefetched = False
        t0 = time.monotonic()
        if pre is not None and pre[1] == len(req.prompt):
            (logits, caches, length), _, t_pre = pre
            prefetched = True
            self.stats["prefetched_prefills"] += 1
            t0 = t_pre
        else:
            logits, caches, length = self._prefill(req.prompt)
        # greedy next token; musicgen picks one token per codebook
        tok = torch.argmax(logits[0], dim=-1)
        first = tok.tolist()                    # waits for the device
        t_first = time.monotonic()
        out_tokens: list = []
        # ``length`` counts the prefix positions already; the JAX package's
        # engine adds ``n_prefix`` once more and decodes past its cache
        pos = length
        for i in range(req.max_new_tokens):
            out_tokens.append(first if i == 0 else tok.tolist())
            logits, caches = decode_step(self.params, self.cfg, tok[None],
                                         caches, pos + i)
            tok = torch.argmax(logits[0], dim=-1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_done = time.monotonic()
        # next-request prediction (subscription)
        prewarm_at = self.observe_arrival(req.client_id, now)
        if prewarm_at is not None:
            # this engine pre-warms immediately; a production deployment
            # schedules it at `prewarm_at`
            self.prewarm(req.client_id, req.prompt, prewarm_at)
        return Completion(req.request_id, out_tokens, t0, t_first, t_done,
                          prefetched, served_at=t_entry)
