"""Attention: GQA (RoPE, optional sliding window), MLA (DeepSeek-V3 style),
prefill and decode paths.

Two plain compute paths:

- ``dense_attention``  — plain masked softmax; used for short sequences.
- ``chunked_attention`` — online-softmax attention over the (q-chunk,
  kv-chunk) pairs the causal/window structure allows, so it does the
  triangle's work, not the full S² square.

``gqa_prefill`` and the training forward ``gqa_forward`` go through
:func:`repro_torch.kernels.ops.flash_attention`: the hand-written kernel K2
on CUDA (under autograd its backward kernel too), ``attention_any`` on the
CPU and the meta device, which autograd differentiates there as the JAX
package's step differentiates it.

MLA is evaluated in its *absorbed* form: the per-head no-PE query is
projected into the KV latent space, so attention runs like MQA with a shared
576-dim key (512 latent + 64 rope) and a 512-dim latent value; the KV cache
stores only the latent.  Its prefill calls ``attention_any`` on every
device, as the JAX package does: K2 takes one head dim for q, k and v, and
MLA's key and value differ (576 and 512).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.launch.ctx import constrain
from repro_torch.models.layers import (DEFAULT_DTYPE, apply_rope, dense_init,
                                       split_last)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int | None = None          # sliding-window size (local attention)
    mla: MLAConfig | None = None
    chunk_size: int = 512              # chunked-attention block
    dense_threshold: int = 2048        # use dense path for S <= this


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def make_attention_params(gen: torch.Generator, cfg: AttentionConfig,
                          dtype=DEFAULT_DTYPE) -> dict:
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "w_dq": dense_init(gen, cfg.d_model, m.q_lora_rank, dtype),
            "w_uq": dense_init(gen, m.q_lora_rank,
                               cfg.n_heads * (m.nope_head_dim
                                              + m.rope_head_dim), dtype),
            "w_dkv": dense_init(gen, cfg.d_model,
                                m.kv_lora_rank + m.rope_head_dim, dtype),
            # per-head absorption matrices
            "w_uk": dense_init(gen, cfg.n_heads * m.nope_head_dim,
                               m.kv_lora_rank, dtype),
            "w_uv": dense_init(gen, m.kv_lora_rank,
                               cfg.n_heads * m.v_head_dim, dtype),
            "w_o": dense_init(gen, cfg.n_heads * m.v_head_dim, cfg.d_model,
                              dtype),
        }
    return {
        "w_q": dense_init(gen, cfg.d_model, cfg.n_heads * cfg.head_dim, dtype),
        "w_k": dense_init(gen, cfg.d_model, cfg.n_kv_heads * cfg.head_dim,
                          dtype),
        "w_v": dense_init(gen, cfg.d_model, cfg.n_kv_heads * cfg.head_dim,
                          dtype),
        "w_o": dense_init(gen, cfg.n_heads * cfg.head_dim, cfg.d_model, dtype),
    }


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

def _gqa_expand(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,Hq,D] -> [B,S,Hkv,G,D]."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def _mask(qpos, kpos, causal: bool, window: int | None) -> torch.Tensor:
    mask = torch.ones((qpos.numel(), kpos.numel()), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def dense_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Plain masked-softmax GQA attention.

    q: [B,Sq,Hq,Dk]; k: [B,Skv,Hkv,Dk]; v: [B,Skv,Hkv,Dv]. Hq % Hkv == 0.
    ``q_offset``: absolute position of q[0] relative to k[0] (decode).
    """
    b, sq, hq, dk = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qg = _gqa_expand(q, hkv)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(skv, device=q.device)
    mask = _mask(qpos, kpos, causal, window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, hq, v.shape[-1])


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, chunk_size: int = 512,
                      scale: float | None = None) -> torch.Tensor:
    """Online-softmax attention over (q-chunk, kv-chunk) pairs.

    Only causally-reachable chunk pairs are visited, one diagonal
    d = i - j at a time: every pair (i, i - d) of a diagonal goes through
    one batched einsum and one carry update, so the op count grows with
    the number of chunks, not its square.  The diagonals run from the
    farthest down to 0, which visits each q chunk's kv chunks in ascending
    order, the JAX package's pair order.  Works for self-attention
    (Sq == Skv) with q and k aligned at position 0.
    """
    b, s, hq, dk = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    if s % chunk_size:
        raise ValueError(f"S={s} is not a multiple of chunk {chunk_size}")
    c = chunk_size
    n = s // c
    wc = None if window is None else max(0, math.ceil(window / c))
    g = hq // hkv
    qg = q.reshape(b, n, c, hkv, g, dk)
    kc = k.reshape(b, n, c, hkv, dk)
    vc = v.reshape(b, n, c, hkv, dv)
    dev = q.device
    base = torch.arange(c, device=dev)
    # one online-softmax carry per q chunk; chunks i < d have not started
    # at diagonal d.  The carry is replaced rather than written in place,
    # so that autograd can differentiate through it
    acc = torch.zeros((b, n, c, hkv, g, dv), dtype=torch.float32, device=dev)
    m = torch.full((b, n, c, hkv, g), -math.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, n, c, hkv, g), dtype=torch.float32, device=dev)
    for d in range(n - 1 if wc is None else min(wc, n - 1), -1, -1):
        logits = torch.einsum("bnskgd,bntkd->bnkgst", qg[:, d:],
                              kc[:, :n - d]).float() * scale
        # every pair of a diagonal has the same mask: the causal one only
        # at d = 0, the window's only where a distance reaches it
        if (causal and d == 0) or (window is not None
                                   and (d + 1) * c - 1 >= window):
            mask = _mask(base + d * c, base, causal, window)
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, NEG_INF))
        m_d, l_d, acc_d = m[:, d:], l[:, d:], acc[:, d:]
        m_blk = torch.amax(logits, dim=-1).movedim(-1, 2)   # [B,n-d,c,K,G]
        m_new = torch.maximum(m_d, m_blk)
        p = torch.exp(logits - m_new.movedim(2, -1)[..., None])
        l_blk = torch.sum(p, dim=-1).movedim(-1, 2)
        alpha = torch.exp(m_d - m_new)
        pv = torch.einsum("bnkgst,bntkd->bnskgd", p.to(v.dtype),
                          vc[:, :n - d])
        acc = torch.cat([acc[:, :d], acc_d * alpha[..., None] + pv.float()],
                        dim=1)
        m = torch.cat([m[:, :d], m_new], dim=1)
        l = torch.cat([l[:, :d], l_d * alpha + l_blk], dim=1)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype).reshape(b, s, hq, dv)


def attention_any(q, k, v, *, causal: bool = True, window: int | None = None,
                  chunk_size: int = 512, dense_threshold: int = 2048,
                  scale: float | None = None) -> torch.Tensor:
    """Choose dense vs chunked path by sequence length.  If the preferred
    chunk does not divide S, fall back to smaller chunks before giving up on
    the chunked path."""
    s = q.shape[1]
    if s > dense_threshold:
        for c in (chunk_size, 256, 128, 64):
            if s % c == 0:
                return chunked_attention(q, k, v, causal=causal,
                                         window=window, chunk_size=c,
                                         scale=scale)
    return dense_attention(q, k, v, causal=causal, window=window,
                           scale=scale)


# ---------------------------------------------------------------------------
# GQA block (projections + rope + attention), prefill and decode
# ---------------------------------------------------------------------------

def _qkv(params, cfg: AttentionConfig, x, positions):
    q = split_last(x @ params["w_q"], cfg.n_heads, cfg.head_dim)
    k = split_last(x @ params["w_k"], cfg.n_kv_heads, cfg.head_dim)
    v = split_last(x @ params["w_v"], cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(params, cfg: AttentionConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Training self-attention.  x: [B,S,D]; positions: [S]."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=True, window=cfg.window,
                              chunk_size=cfg.chunk_size,
                              dense_threshold=cfg.dense_threshold)
    return out.reshape(b, s, -1) @ params["w_o"]


def gqa_prefill(params, cfg: AttentionConfig, x, positions):
    """Prefill: returns (out, kv_cache) with cache [B,S,Hkv,D] each."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=True, window=cfg.window,
                              chunk_size=cfg.chunk_size,
                              dense_threshold=cfg.dense_threshold)
    out = out.reshape(b, s, -1) @ params["w_o"]
    return out, {"k": k, "v": v}


def _positions(cache_len, device) -> torch.Tensor:
    """The decode position as a [1] int64 tensor: from a Python int, or a
    view of a 0-d tensor already on the device (a captured decode step
    reads its position there)."""
    if isinstance(cache_len, torch.Tensor):
        return cache_len.reshape(1)
    return torch.full((1,), int(cache_len), dtype=torch.int64, device=device)


def _write(cache: torch.Tensor, at, new: torch.Tensor) -> None:
    """cache[:, at] = new[:, 0] in place.  A Python int writes through a
    slice, which a DTensor cache on a mesh takes too; a [1] device tensor
    through ``index_copy_``, with no read-back to the host."""
    if isinstance(at, torch.Tensor):
        cache.index_copy_(1, at, new)
    else:
        cache[:, at] = new[:, 0]


def gqa_decode(params, cfg: AttentionConfig, x, cache, cache_len):
    """One-token decode.  x: [B,1,D]; cache k/v: [B,Smax,Hkv,D];
    cache_len: number of valid cache positions, an int or a 0-d int64
    tensor on ``x``'s device (bitwise the same result).  Returns (out
    [B,1,D], cache).  The new key and value are written into ``cache`` in
    place (the JAX package returns updated copies); the cache belongs to
    the caller's sequence, so nothing else sees the write.

    Sliding-window layers may use a RING cache of size <= window: the write
    index wraps (``pos % Smax``) and positions the window can no longer see
    are overwritten in place — softmax is permutation-invariant over the key
    set, and rope was applied at each key's absolute position.
    """
    b = x.shape[0]
    smax = cache["k"].shape[1]
    posv = _positions(cache_len, x.device)
    # a tensor position stays on the device: the write, the ring's modulo
    # and the masks read it there
    pos = posv if isinstance(cache_len, torch.Tensor) else int(cache_len)
    ring = cfg.window is not None and smax <= cfg.window
    q, k, v = _qkv(params, cfg, x, posv)
    write_at = pos % smax if ring else pos
    k_cache, v_cache = cache["k"], cache["v"]
    _write(k_cache, write_at, k)
    _write(v_cache, write_at, v)
    k_cache = constrain(k_cache, "kv_cache")
    v_cache = constrain(v_cache, "kv_cache")

    def attend(q, k_cache, v_cache):
        qg = _gqa_expand(q, k_cache.shape[2])                 # [B,1,K,G,D]
        logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                              k_cache.float())
        logits = logits / math.sqrt(cfg.head_dim)
        kpos = torch.arange(smax, device=q.device)
        valid = kpos <= pos    # warm-up; all-true once the ring is full
        if cfg.window is not None and not ring:
            valid &= kpos > pos - cfg.window
        logits = torch.where(valid, logits,
                             torch.full_like(logits, NEG_INF))
        probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v_cache)
        return out.reshape(*q.shape[:3], v_cache.shape[-1])

    out = ops.attention_per_rank(attend, q, k_cache, v_cache)
    out = out.reshape(b, 1, -1) @ params["w_o"]
    return out, {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# MLA (absorbed form)
# ---------------------------------------------------------------------------

def _mla_qkv(params, cfg: AttentionConfig, x, positions):
    """Absorbed-form q' (latent space), rope query, latent and rope key."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    cq = x @ params["w_dq"]
    q = (cq @ params["w_uq"]).reshape(b, s, h,
                                      m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    # absorb W_uk: q' = q_nope @ W_uk (per head) -> latent dim
    w_uk = params["w_uk"].reshape(h, m.nope_head_dim, m.kv_lora_rank)
    q_lat = torch.einsum("bshd,hdr->bshr", q_nope, w_uk)
    ckv = x @ params["w_dkv"]
    c_lat, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_lat, q_rope, c_lat, k_rope[:, :, 0, :]


def _mla_out(params, cfg: AttentionConfig, attn_lat):
    """attn_lat: [B,S,H,latent] -> output projection."""
    m = cfg.mla
    b, s, h, _ = attn_lat.shape
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = torch.einsum("bshr,rhd->bshd", attn_lat, w_uv)
    return o.reshape(b, s, h * m.v_head_dim) @ params["w_o"]


def _mla_scale(m: MLAConfig) -> float:
    return 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)


def _mla_attend(params, cfg: AttentionConfig, x, positions):
    """MQA over the shared (latent ⊕ rope) key; returns (out, c, k_rope)."""
    q_lat, q_rope, c_lat, k_rope = _mla_qkv(params, cfg, x, positions)
    q_cat = torch.cat([q_lat, q_rope], dim=-1)               # [B,S,H,dc+dr]
    k_cat = torch.cat([c_lat, k_rope], dim=-1)[:, :, None, :]
    attn = ops.attention_per_rank(functools.partial(
        attention_any, causal=True, chunk_size=cfg.chunk_size,
        dense_threshold=cfg.dense_threshold, scale=_mla_scale(cfg.mla)),
        q_cat, k_cat, c_lat[:, :, None, :])
    return _mla_out(params, cfg, attn), c_lat, k_rope


def mla_forward(params, cfg: AttentionConfig, x, positions):
    """MLA self-attention (training).  Absorbed form: MQA with shared
    (latent ⊕ rope) key of dim kv_lora_rank + rope_head_dim."""
    return _mla_attend(params, cfg, x, positions)[0]


def mla_prefill(params, cfg: AttentionConfig, x, positions):
    """Prefill: returns (out, latent-only cache ``c`` [B,S,R], ``k_rope``
    [B,S,Dr])."""
    out, c_lat, k_rope = _mla_attend(params, cfg, x, positions)
    return out, {"c": c_lat, "k_rope": k_rope}


def mla_decode(params, cfg: AttentionConfig, x, cache, cache_len):
    """One-token decode over the latent cache; the new latent and rope key
    are written into ``cache`` in place, and ``cache_len`` is an int or a
    0-d device tensor, as in ``gqa_decode``."""
    posv = _positions(cache_len, x.device)
    pos = posv if isinstance(cache_len, torch.Tensor) else int(cache_len)
    q_lat, q_rope, c_lat, k_rope = _mla_qkv(params, cfg, x, posv)
    c_cache, kr_cache = cache["c"], cache["k_rope"]
    _write(c_cache, pos, c_lat)
    _write(kr_cache, pos, k_rope)
    c_cache = constrain(c_cache, "latent_cache")
    kr_cache = constrain(kr_cache, "latent_cache")

    def attend(q_lat, q_rope, c_cache, kr_cache):
        logits = (torch.einsum("bshr,btr->bhst", q_lat, c_cache)
                  + torch.einsum("bshr,btr->bhst", q_rope, kr_cache))
        logits = logits.float() * _mla_scale(cfg.mla)
        valid = torch.arange(c_cache.shape[1], device=q_lat.device) <= pos
        logits = torch.where(valid, logits,
                             torch.full_like(logits, NEG_INF))
        probs = torch.softmax(logits, dim=-1).to(c_cache.dtype)
        return torch.einsum("bhst,btr->bshr", probs, c_cache)

    if isinstance(q_lat, DTensor):
        # per rank: local batch, query heads over model; the latent cache
        # has no heads and is replicated over model
        split = cfg.n_heads % ops.model_size(q_lat) == 0
        attn = ops.per_rank(attend, (q_lat, q_rope, c_cache, kr_cache),
                            ((True, 2), (True, 2), (True, None),
                             (True, None)), ((True, 2),), split)
    else:
        attn = attend(q_lat, q_rope, c_cache, kr_cache)
    return _mla_out(params, cfg, attn), {"c": c_cache, "k_rope": kr_cache}
