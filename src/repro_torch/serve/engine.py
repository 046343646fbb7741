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
kernel.  Decode runs through one :class:`DecodeProgram` per engine: on
CUDA one decode step captured in a CUDA graph and replayed per token (the
counterpart of the JAX package's jitted decode step), on the CPU the same
step eagerly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree

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


class DecodeProgram:
    """Greedy decode of one sequence over fixed buffers: every layer's
    cache, the input token ([1], or [1, CB] with codebooks), the position
    (a 0-d int64 tensor) and the logits.

    One step runs ``decode_step`` at the position buffer, which writes
    attention caches and Mamba's states in place into the buffers (a cache
    it returns as another tensor, as on a mesh, is copied into its buffer),
    writes the argmax into the token buffer and advances the position, all
    on the device.  On CUDA the step is captured once in a
    ``torch.cuda.CUDAGraph`` (after one warm-up step on the capture's
    stream) and every later step replays it; a capture that fails raises.
    On the CPU the step runs eagerly.  Requests load their caches into the
    buffers by copy, so a prefill's or prewarmed cache's own tensors are
    never written.
    """

    def __init__(self, params, cfg: ModelConfig, caches, token: torch.Tensor):
        self.params, self.cfg = params, cfg
        self.device = token.device
        self.caches = pytree.tree_map(torch.empty_like, caches)
        self.token = torch.empty_like(token)[None]
        self.pos = torch.zeros((), dtype=torch.int64, device=self.device)
        self.logits: torch.Tensor | None = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.capture_seconds: float | None = None

    def load(self, caches, token: torch.Tensor, pos: int) -> None:
        for buf, src in zip(pytree.tree_leaves(self.caches),
                            pytree.tree_leaves(caches), strict=True):
            buf.copy_(src)
        self.token[0].copy_(token)
        self.pos.fill_(pos)

    def _step(self) -> torch.Tensor:
        logits, caches = decode_step(self.params, self.cfg, self.token,
                                     self.caches, self.pos)
        for buf, new in zip(pytree.tree_leaves(self.caches),
                            pytree.tree_leaves(caches), strict=True):
            if new is not buf:
                buf.copy_(new)
        self.token[0].copy_(torch.argmax(logits[0], dim=-1))
        self.pos.add_(1)
        return logits

    def capture(self) -> None:
        """Warm up on a side stream (the step runs for real and writes the
        buffers: reload them before replaying) and capture one step."""
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._step()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            self.logits = self._step()
        torch.cuda.synchronize(self.device)
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    def advance(self) -> None:
        """One step: the captured graph's replay, or the eager step."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self.logits = self._step()

    def decode(self, caches, token: torch.Tensor, pos: int,
               steps: int) -> torch.Tensor:
        """``steps`` steps from ``token`` at ``pos`` over ``caches``;
        returns each step's input token, [steps] or [steps, CB], on the
        device.  On CUDA the first call captures the step."""
        if self.device.type == "cuda" and self.graph is None:
            self.load(caches, token, pos)
            self.capture()
        self.load(caches, token, pos)
        out = torch.empty((steps, *token.shape), dtype=self.token.dtype,
                          device=self.device)
        for i in range(steps):
            out[i].copy_(self.token[0])
            self.advance()
        return out


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
        self.program: DecodeProgram | None = None    # made at first decode
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
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            # a captured step cannot check its write position on the host
            raise ValueError(f"request {req.request_id}: {len(req.prompt)} "
                             f"prompt and {req.max_new_tokens} new tokens "
                             f"exceed max_len={self.max_len}")
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
        tok.tolist()            # the first token's read-back: waits for it
        t_first = time.monotonic()
        if self.program is None:
            self.program = DecodeProgram(self.params, self.cfg, caches, tok)
        # ``length`` counts the prefix positions already; the JAX package's
        # engine adds ``n_prefix`` once more and decodes past its cache
        toks = self.program.decode(caches, tok, length, req.max_new_tokens)
        out_tokens = toks.tolist()              # one read-back, at the end
        t_done = time.monotonic()
        # next-request prediction (subscription)
        prewarm_at = self.observe_arrival(req.client_id, now)
        if prewarm_at is not None:
            # this engine pre-warms immediately; a production deployment
            # schedules it at `prewarm_at`
            self.prewarm(req.client_id, req.prompt, prewarm_at)
        return Completion(req.request_id, out_tokens, t0, t_first, t_done,
                          prefetched, served_at=t_entry)
