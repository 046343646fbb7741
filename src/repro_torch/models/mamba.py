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
with the chunk padding.

The work around the scan that the JAX package's jitted steps leave to
XLA's fusion runs as hand-written kernels on CUDA, through
:mod:`repro_torch.kernels.ops`: the three causal convs with their SiLU in
one launch (K6, ``ops.causal_conv``), the D skip with the gated norm (K7,
``ops.gated_norm``), both under autograd in training, and the decode's
convs, dt, decay, state update and D skip (K8, ``ops.decode_layer``), which
writes the layer's states in place.  On the CPU they are the JAX package's
ops (:func:`_causal_conv`, :func:`_gated_norm`; the decode's written in
place too), which autograd differentiates.  On a mesh each runs per rank.

Projections are kept separate (w_z, w_x, w_B, w_C, w_dt), as in the JAX
package, so its parameters carry across unchanged.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.gated_norm import gated_norm_plain
from repro_torch.kernels.mamba_conv import causal_conv_plain
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


# the JAX package's _causal_conv, K6's plain version
_causal_conv = causal_conv_plain


def _project(params, x):
    """x: [B,S,D] -> z, xs, B, C, dt (pre-conv, pre-activation)."""
    return (x @ params["w_z"], x @ params["w_x"], x @ params["w_B"],
            x @ params["w_C"], x @ params["w_dt"])


def _gated_norm(y, z, scale, eps=1e-6):
    """The JAX package's ``_gated_norm``: K7's plain version without the D
    skip."""
    return gated_norm_plain(y, None, z, None, scale, eps)


def _conv_params(params):
    return ([params["conv_x_w"], params["conv_B_w"], params["conv_C_w"]],
            [params["conv_x_b"], params["conv_B_b"], params["conv_C_b"]])


def _ssd_full(params, cfg: MambaConfig, x, conv_state=None,
              want_state=False):
    """Shared forward core; the SSD runs on (each rank's local) tensors
    through ``ops.local_ssd_scan`` (K3 on CUDA).  Returns (out,
    state_dict_or_None)."""
    b, s, _ = x.shape
    di, g, n, h, p = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                      cfg.head_dim)
    z, xs, Bm, Cm, dt = _project(params, x)
    (xs, Bm, Cm), conv = ops.causal_conv(
        [xs, Bm, Cm], *_conv_params(params),
        [conv_state[k] for k in "xBC"] if conv_state else None,
        want_state=want_state)
    xs = xs.reshape(b, s, h, p)
    Bm = Bm.reshape(b, s, g, n)
    Cm = Cm.reshape(b, s, g, n)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    def ssd(xs, dt, A, Bm, Cm, chunk_size):
        # pad to a chunk multiple with dt = 0: dA = 0 so the padded
        # positions leave the SSM state untouched and the final state
        # stays exact
        pad = (-s) % chunk_size
        if pad:
            y, final_state = ops.local_ssd_scan(
                F.pad(xs, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
                A, F.pad(Bm, (0, 0, 0, 0, 0, pad)),
                F.pad(Cm, (0, 0, 0, 0, 0, pad)), chunk_size=chunk_size)
            return y[:, :s], final_state
        return ops.local_ssd_scan(xs, dt, A, Bm, Cm, chunk_size=chunk_size)

    # on a mesh, per rank: the local batch and heads
    y, final_state = ops.ssd_per_rank(ssd, xs, dt, A, Bm, Cm,
                                      chunk_size=cfg.chunk_size)
    # the D skip and the gated norm (K7 on CUDA)
    y = ops.gated_norm(y.reshape(b, s, di), xs.reshape(b, s, di), z,
                       params["D"], params["norm_scale"])
    out = y @ params["out_proj"]
    if not want_state:
        return out, None
    return out, {"ssm": final_state, "conv": dict(zip("xBC", conv))}


def mamba_forward(params, cfg: MambaConfig, x: torch.Tensor) -> torch.Tensor:
    """Training forward (no state I/O).  x: [B,S,D]."""
    return _ssd_full(params, cfg, x)[0]


def mamba_prefill(params, cfg: MambaConfig, x: torch.Tensor):
    """Prefill returning recurrent state for decode."""
    return _ssd_full(params, cfg, x, want_state=True)


def mamba_decode(params, cfg: MambaConfig, x: torch.Tensor, state):
    """Single-token decode.  x: [B,1,D]; state: {"ssm": [B,H,N,P] fp32,
    "conv": {x/B/C: [B,K-1,·]}}.  O(1) in sequence length.  The state's
    tensors are written in place and returned (on a mesh, the tensors each
    rank wrote, which may be new DTensors: keep what is returned)."""
    b = x.shape[0]
    di = cfg.d_inner
    z, xs, Bm, Cm, dt = _project(params, x)
    # the three convs from their states, dt's softplus, the decay, the state
    # update and the D skip in one step (K8 on CUDA; on a mesh per rank:
    # local batch, heads over model when they, and the groups or a single
    # group, divide it)
    y, conv, ssm = ops.decode_layer(
        xs, Bm, Cm, dt, *_conv_params(params),
        [state["conv"][k] for k in "xBC"], state["ssm"], params["dt_bias"],
        params["A_log"], params["D"])
    y = ops.gated_norm(y.reshape(b, 1, di).to(x.dtype), None, z, None,
                       params["norm_scale"])
    out = y @ params["out_proj"]
    return out, {"ssm": ssm, "conv": dict(zip("xBC", conv))}
