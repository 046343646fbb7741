"""Mamba-2 (SSD — state-space duality) block.

The SSD chunked algorithm (Dao & Gu, 2024): split the sequence into chunks,
compute the intra-chunk part as a masked attention-like product and carry
inter-chunk states with a sequential scan over chunks.  The prefill's scan
goes through :func:`repro_torch.kernels.ops.local_ssd_scan`: the
hand-written kernel K3 on CUDA, :func:`ssd_chunked` on the CPU.  So does
the training forward, ``mamba_forward``: on CUDA autograd differentiates
K3 through its backward kernel (``ops.SSDScan``), on the CPU it
differentiates :func:`ssd_chunked`, as the JAX package does.  On a mesh
both run per rank on the local batch and heads (``ops.ssd_per_rank``),
with the chunk padding and the ``D`` skip, and so does the decode's state
update.

Projections are kept separate (w_z, w_x, w_B, w_C, w_dt), as in the JAX
package, so its parameters carry across unchanged.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.models.layers import (DEFAULT_DTYPE, dense_init, init_device,
                                       made, normal)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 128           # N
    head_dim: int = 64           # P
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk_size: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def make_mamba_params(gen: torch.Generator, cfg: MambaConfig,
                      dtype=DEFAULT_DTYPE) -> dict:
    di, n, g, h = cfg.d_inner, cfg.d_state, cfg.n_groups, cfg.n_heads
    dev = init_device(gen)

    def zeros(d, zdtype=dtype):
        return made(torch.zeros(d, dtype=zdtype, device=dev))

    def ones(d):
        return made(torch.ones(d, dtype=torch.float32, device=dev))

    return {
        "w_z": dense_init(gen, cfg.d_model, di, dtype),
        "w_x": dense_init(gen, cfg.d_model, di, dtype),
        "w_B": dense_init(gen, cfg.d_model, g * n, dtype),
        "w_C": dense_init(gen, cfg.d_model, g * n, dtype),
        "w_dt": dense_init(gen, cfg.d_model, h, dtype),
        "conv_x_w": normal(gen, (cfg.d_conv, di), 0.1, dtype),
        "conv_x_b": zeros(di),
        "conv_B_w": normal(gen, (cfg.d_conv, g * n), 0.1, dtype),
        "conv_B_b": zeros(g * n),
        "conv_C_w": normal(gen, (cfg.d_conv, g * n), 0.1, dtype),
        "conv_C_b": zeros(g * n),
        "A_log": made(torch.log(torch.linspace(1.0, 16.0, h,
                                               dtype=torch.float32,
                                               device=dev))),
        "dt_bias": zeros(h, torch.float32),
        "D": ones(h),
        "norm_scale": ones(di),
        "out_proj": dense_init(gen, di, cfg.d_model, dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] for
    i >= j, -inf otherwise.  x: [..., L]."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, torch.full_like(diff, -torch.inf))


def ssd_chunked(x, dt, A, B, C, chunk_size: int):
    """Exact SSD over chunks.

    x: [Bt, S, H, P]; dt: [Bt, S, H] (already softplus'd, >0);
    A: [H] (negative); B, C: [Bt, S, G, N] with H % G == 0.
    Returns y: [Bt, S, H, P] and final state [Bt, H, N, P] (fp32).
    """
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    l = chunk_size
    if s % l:
        raise ValueError(f"S={s} is not a multiple of chunk {l}")
    nc = s // l
    rep = h // g

    xc = x.reshape(bt, nc, l, h, p)
    dtc = dt.reshape(bt, nc, l, h)
    Bc = B.reshape(bt, nc, l, g, n)
    Cc = C.reshape(bt, nc, l, g, n)
    dA = dtc * A[None, None, None, :]                     # [Bt,nc,l,H] (<=0)

    # intra-chunk (attention-like with decay mask)
    seg = _segsum(dA.movedim(-1, -2))                     # [Bt,nc,H,l,l]
    decay = torch.exp(seg)
    Bh = torch.repeat_interleave(Bc, rep, dim=3)          # [Bt,nc,l,H,N]
    Ch = torch.repeat_interleave(Cc, rep, dim=3)
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)   # [Bt,nc,H,l,l]
    scores = scores * decay.to(scores.dtype)
    xdt = xc * dtc[..., None].to(xc.dtype)                # [Bt,nc,l,H,P]
    y_intra = torch.einsum("bchls,bcshp->bclhp", scores.to(x.dtype), xdt)

    # chunk states: S_c = sum_j exp(cum_end - cum_j) B_j (dt_j x_j)
    cum = torch.cumsum(dA, dim=2)                         # [Bt,nc,l,H]
    total = cum[:, :, -1:, :]                             # [Bt,nc,1,H]
    state_decay = torch.exp(total - cum)                  # [Bt,nc,l,H]
    states = torch.einsum("bclhn,bclh,bclhp->bchnp",
                          Bh, state_decay.to(x.dtype), xdt)

    # inter-chunk recurrence over chunks (state carried in fp32)
    chunk_decay = torch.exp(total[:, :, 0, :])            # [Bt,nc,H]
    s_prev = torch.zeros((bt, h, n, p), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + \
            states[:, c].float()
    prev_states = torch.stack(prev, dim=1)                # [Bt,nc,H,N,P]

    # inter-chunk output: C_i · (decay_i * S_prev)
    in_decay = torch.exp(cum)                             # [Bt,nc,l,H]
    y_inter = torch.einsum("bclhn,bchnp,bclh->bclhp",
                           Ch, prev_states.to(x.dtype), in_decay.to(x.dtype))
    y = (y_intra + y_inter).reshape(bt, s, h, p)
    return y, s_prev


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d.  x: [B,S,C]; w: [K,C]; returns (y, new_state)
    where state is the last K-1 inputs for decode."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)                       # [B,S+K-1,C]
    s = x.shape[1]
    y = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + s, :] * w[i][None, None, :]
    y = y + b[None, None, :]
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return F.silu(y.float()).to(x.dtype), new_state


def _project(params, x):
    """x: [B,S,D] -> z, xs, B, C, dt (pre-conv, pre-activation)."""
    return (x @ params["w_z"], x @ params["w_x"], x @ params["w_B"],
            x @ params["w_C"], x @ params["w_dt"])


def _gated_norm(y, z, scale, eps=1e-6):
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _ssd_full(params, cfg: MambaConfig, x, conv_state=None,
              want_state=False):
    """Shared forward core; the SSD runs on (each rank's local) tensors
    through ``ops.local_ssd_scan`` (K3 on CUDA).  Returns (out,
    state_dict_or_None)."""
    b, s, _ = x.shape
    di, g, n, h, p = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                      cfg.head_dim)
    z, xs, Bm, Cm, dt = _project(params, x)
    xs, conv_x = _causal_conv(xs, params["conv_x_w"], params["conv_x_b"],
                              conv_state["x"] if conv_state else None)
    Bm, conv_B = _causal_conv(Bm, params["conv_B_w"], params["conv_B_b"],
                              conv_state["B"] if conv_state else None)
    Cm, conv_C = _causal_conv(Cm, params["conv_C_w"], params["conv_C_b"],
                              conv_state["C"] if conv_state else None)
    xs = xs.reshape(b, s, h, p)
    Bm = Bm.reshape(b, s, g, n)
    Cm = Cm.reshape(b, s, g, n)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    def ssd(xs, dt, A, Bm, Cm, D, chunk_size):
        # pad to a chunk multiple with dt = 0: dA = 0 so the padded
        # positions leave the SSM state untouched and the final state
        # stays exact
        pad = (-s) % chunk_size
        if pad:
            y, final_state = ops.local_ssd_scan(
                F.pad(xs, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
                A, F.pad(Bm, (0, 0, 0, 0, 0, pad)),
                F.pad(Cm, (0, 0, 0, 0, 0, pad)), chunk_size=chunk_size)
            y = y[:, :s]
        else:
            y, final_state = ops.local_ssd_scan(xs, dt, A, Bm, Cm,
                                                chunk_size=chunk_size)
        return y + xs * D[None, None, :, None].to(xs.dtype), final_state

    # on a mesh, per rank: the local batch and heads
    y, final_state = ops.ssd_per_rank(ssd, xs, dt, A, Bm, Cm, params["D"],
                                      chunk_size=cfg.chunk_size)
    y = _gated_norm(y.reshape(b, s, di), z, params["norm_scale"])
    out = y @ params["out_proj"]
    if not want_state:
        return out, None
    return out, {"ssm": final_state,
                 "conv": {"x": conv_x, "B": conv_B, "C": conv_C}}


def mamba_forward(params, cfg: MambaConfig, x: torch.Tensor) -> torch.Tensor:
    """Training forward (no state I/O).  x: [B,S,D]."""
    return _ssd_full(params, cfg, x)[0]


def mamba_prefill(params, cfg: MambaConfig, x: torch.Tensor):
    """Prefill returning recurrent state for decode."""
    return _ssd_full(params, cfg, x, want_state=True)


def mamba_decode(params, cfg: MambaConfig, x: torch.Tensor, state):
    """Single-token decode.  x: [B,1,D]; state: {"ssm": [B,H,N,P] fp32,
    "conv": {x/B/C: [B,K-1,·]}}.  O(1) in sequence length."""
    b = x.shape[0]
    di, g, n, h, p = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                      cfg.head_dim)
    z, xs, Bm, Cm, dt = _project(params, x)
    xs, conv_x = _causal_conv(xs, params["conv_x_w"], params["conv_x_b"],
                              state["conv"]["x"])
    Bm, conv_B = _causal_conv(Bm, params["conv_B_w"], params["conv_B_b"],
                              state["conv"]["B"])
    Cm, conv_C = _causal_conv(Cm, params["conv_C_w"], params["conv_C_b"],
                              state["conv"]["C"])
    xs = xs.reshape(b, 1, h, p)[:, 0]                           # [B,H,P]
    Bm = Bm.reshape(b, g, n)
    Cm = Cm.reshape(b, g, n)
    dt = F.softplus(dt.float() + params["dt_bias"])[:, 0]
    A = -torch.exp(params["A_log"])

    def step(xs, ssm, dt, A, Bm, Cm, D):
        dA = torch.exp(dt * A[None, :])                         # [B,H]
        rep = xs.shape[1] // Bm.shape[1]
        Bh = torch.repeat_interleave(Bm, rep, dim=1)            # [B,H,N]
        Ch = torch.repeat_interleave(Cm, rep, dim=1)
        s_new = (ssm * dA[..., None, None]
                 + torch.einsum("bhn,bh,bhp->bhnp", Bh.float(), dt,
                                xs.float()))
        y = torch.einsum("bhn,bhnp->bhp", Ch, s_new.to(xs.dtype))
        return s_new, y + xs * D[None, :, None].to(xs.dtype)

    if isinstance(xs, DTensor):
        # per rank: local batch, heads over model when they (and the
        # groups, or a single group) divide it
        tp = ops.model_size(xs)
        bc = (True, 1 if g > 1 else None)
        s_new, y = ops.per_rank(
            step, (xs, state["ssm"], dt, A, Bm, Cm, params["D"]),
            ((True, 1), (True, 1), (True, 1), (False, 0), bc, bc,
             (False, 0)),
            ((True, 1), (True, 1)),
            h % tp == 0 and (g == 1 or g % tp == 0))
    else:
        s_new, y = step(xs, state["ssm"], dt, A, Bm, Cm, params["D"])
    y = _gated_norm(y.reshape(b, 1, di).to(x.dtype), z, params["norm_scale"])
    out = y @ params["out_proj"]
    return out, {"ssm": s_new, "conv": {"x": conv_x, "B": conv_B,
                                        "C": conv_C}}
