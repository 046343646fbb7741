"""Basic neural layers: norms, RoPE, MLPs, their initialisers and the loss.

Parameters are plain nested dicts of tensors, laid out as in ``repro``
(weights ``[d_in, d_out]``, applied as ``x @ w``), so the JAX package's
arrays carry across unchanged (:func:`repro_torch.convert.params_from_numpy`).
Initialisers draw from an explicit :class:`torch.Generator` on that
generator's device; they cannot reproduce ``jax.random``'s numbers.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels import ops
# the plain RMSNorm; the models run it through ops.add_rmsnorm (K9)
from repro_torch.kernels.unit_norm import rmsnorm_plain as rmsnorm  # noqa

DEFAULT_DTYPE = torch.bfloat16

_META_INIT = contextvars.ContextVar("meta_init", default=False)
_ON_LEAF = contextvars.ContextVar("on_leaf", default=None)


@contextlib.contextmanager
def meta_init():
    """Initialisers make meta tensors (shapes and dtypes, no storage)."""
    token = _META_INIT.set(True)
    try:
        yield
    finally:
        _META_INIT.reset(token)


@contextlib.contextmanager
def on_leaf(fn):
    """Every parameter leaf the initialisers make passes through ``fn``,
    in the order they make them, and what ``fn`` returns takes its place
    (the sharded init places each leaf as soon as it is drawn)."""
    token = _ON_LEAF.set(fn)
    try:
        yield
    finally:
        _ON_LEAF.reset(token)


def made(leaf: torch.Tensor) -> torch.Tensor:
    """A parameter leaf as an initialiser returns it: through the
    :func:`on_leaf` hook where one is set."""
    fn = _ON_LEAF.get()
    return leaf if fn is None else fn(leaf)


def init_device(gen: torch.Generator) -> torch.device:
    """Where the initialisers put their draws: ``gen``'s device, or meta
    under :func:`meta_init`."""
    return torch.device("meta") if _META_INIT.get() else gen.device


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32 on ``gen``'s device, cast.  The
    draw is scaled in place: one float32 copy at a time (14 GiB for one of
    deepseek-v3's stacked expert weights)."""
    x = torch.randn(shape, generator=gen, device=init_device(gen),
                    dtype=torch.float32)
    leaf = x.mul_(scale).to(dtype)
    del x
    return made(leaf)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=DEFAULT_DTYPE,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), scale, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=DEFAULT_DTYPE) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype)


def norm_init(d: int, device, dtype=torch.float32) -> torch.Tensor:
    # norm scales kept in fp32 (tiny, numerically sensitive)
    return made(torch.ones(d, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def split_last(t: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """[..., a*b] -> [..., a, b].  A DTensor whose last dimension is split
    over a mesh axis that does not divide ``a`` (arctic's 56 heads, or
    musicgen's 4 codebooks, over 16 ranks) is gathered over that axis
    first: DTensor cannot split a sharded dimension unevenly."""
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, t.dim() - 1
        keep = [Replicate() if p.is_shard(last) and a % mesh.size(i) else p
                for i, p in enumerate(t.placements)]
        if keep != list(t.placements):
            t = t.redistribute(mesh, keep)
    return t.reshape(*t.shape[:-1], a, b)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a fill on the device, not a host tensor copied over: a captured
    # decode step cannot copy from pageable host memory
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding.  x: [..., S, H, D]; positions: [..., S]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)               # [D/2]
    angles = positions[..., :, None].float() * freqs     # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    # silu(float(g)) rounded to x's type, times u: K10 on the card
    h = ops.swiglu_gate(g, u)
    return h @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu((x @ w_up).float(), approximate="tanh")
    return h.to(x.dtype) @ w_down


# ---------------------------------------------------------------------------
# parameter factories
# ---------------------------------------------------------------------------

def make_mlp_params(gen: torch.Generator, d_model: int, d_ff: int,
                    gated: bool = True, dtype=DEFAULT_DTYPE) -> dict:
    if gated:
        return {
            "w_gate": dense_init(gen, d_model, d_ff, dtype),
            "w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype),
        }
    return {
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in params:
        return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
    return gelu_mlp(x, params["w_up"], params["w_down"])


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy; logits [..., V] in any float dtype.

    The logsumexp is taken in float32 with its max held out of the
    gradient, as in the JAX package.  The gold logit is gathered: for finite
    logits that equals the JAX package's one-hot contraction exactly, and
    it needs no [..., V] float32 one-hot.
    """
    if isinstance(logits, DTensor):
        # the gold-logit gather has no sharding rule over a split vocab or
        # partial sums: the logits are all-gathered (or all-reduced) here
        # over the axes that split the vocab (or hold partial sums)
        last = logits.dim() - 1
        logits = logits.redistribute(
            logits.device_mesh,
            [Replicate() if p.is_shard(last) or p.is_partial() else p
             for p in logits.placements])
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    logz = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
