"""Plain oracles for the attention and SSD kernels.

Deliberately naive (materialise the full score matrix / run the exact
per-token SSM recurrence) so correctness is self-evident; the kernels and
the models' chunked paths are held against them.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    """Naive GQA attention.  q: [B,S,Hq,D]; k,v: [B,S,Hkv,D]."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def ssd_ref(x, dt, A, B, C, keep_every: int | None = None):
    """Exact sequential SSM recurrence (the definition SSD must match).

    x: [Bt,S,H,P]; dt: [Bt,S,H] (>0); A: [H] (<0); B,C: [Bt,S,G,N].
    Returns (y [Bt,S,H,P], final_state [Bt,H,N,P]) in fp32; with
    ``keep_every``, also the state before every ``keep_every``-th position
    (the state entering each chunk of that many positions)
    [Bt, ceil(S / keep_every), H, N, P].
    """
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = torch.repeat_interleave(B, rep, dim=2).float()   # [Bt,S,H,N]
    Ch = torch.repeat_interleave(C, rep, dim=2).float()
    xf = x.float()
    dtf = dt.float()
    dA = torch.exp(dtf * A[None, None, :])                 # [Bt,S,H]
    state = torch.zeros((bt, h, n, p), dtype=torch.float32, device=x.device)
    ys, kept = [], []
    for t in range(s):
        if keep_every and t % keep_every == 0:
            kept.append(state)
        state = state * dA[:, t, :, None, None] + torch.einsum(
            "bhn,bh,bhp->bhnp", Bh[:, t], dtf[:, t], xf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    if keep_every:
        return torch.stack(ys, dim=1), state, torch.stack(kept, dim=1)
    return torch.stack(ys, dim=1), state
