"""Decoder stack: embedding, prelude + repeated unit of layers, final norm
and head; the training forward and loss, prefill and one-token decode.

A model is a *prelude* (irregular leading layers, e.g. DeepSeek's first
dense layers) followed by ``n_units`` repetitions of a *pattern* (a tuple of
``LayerSpec``):

- jamba:   8-layer unit  attention at index 4, mamba elsewhere; MoE on odd
  layers
- gemma3:  6-layer unit  5×(attn_local, dense) + 1×(attn_global, dense)
- deepseek: prelude 3×(mla, dense) + unit (mla, moe), and an MTP layer
- mamba2:  unit (mamba, none)

Unit parameters are a list over units of lists over the pattern (the JAX
package stacks them on a leading axis for ``lax.scan``; here the units are
a Python loop, so there is no ``scan_units``).  Each unit of the training
forward is rematerialised in the backward as ``ModelConfig.remat`` says,
through ``torch.utils.checkpoint``.

Each layer's residual add is fused into the next RMSNorm (K9 on the card,
``kernels.ops.add_rmsnorm``): a layer takes and returns the stream ``x``
and the branch output ``h`` still to be added to it, from layer to layer
and unit to unit (through the checkpoint boundary), and the final norm
adds the last one.  On the CPU that runs the same ops in the same order as
adding each branch at the end of its layer.

Modality frontends ([audio] musicgen, [vlm] paligemma) are stubs, as in the
JAX package: ``prefix_embeddings`` (precomputed frame/patch embeddings) are
concatenated in front of the token embeddings.  MusicGen's 4 EnCodec
codebooks are handled with summed codebook embeddings and 4 parallel output
heads.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.attention import (AttentionConfig, gqa_decode,
                                          gqa_forward, gqa_prefill,
                                          make_attention_params, mla_decode,
                                          mla_forward, mla_prefill)
from repro_torch.launch.shardings import param_shardings, place_local
from repro_torch.models.layers import (DEFAULT_DTYPE, cross_entropy_loss,
                                       embed_init, init_device,
                                       make_mlp_params, meta_init, mlp_apply,
                                       norm_init, on_leaf, split_last)
from repro_torch.models.mamba import (MambaConfig, make_mamba_params,
                                      mamba_decode, mamba_forward,
                                      mamba_prefill)
from repro_torch.models.moe import MoEConfig, make_moe_params, moe_apply

LayerSpec = tuple[str, str]          # (mixer, ffn)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    vocab: int
    pattern: tuple[LayerSpec, ...]
    prelude: tuple[LayerSpec, ...] = ()
    attn: AttentionConfig | None = None
    attn_global: AttentionConfig | None = None   # for attn_global mixer
    mamba: MambaConfig | None = None
    moe: MoEConfig | None = None
    d_ff: int = 0
    gated_mlp: bool = True
    n_prefix: int = 0                 # modality-stub prefix tokens
    codebooks: int = 1                # musicgen: 4
    tie_embeddings: bool = True
    mtp: bool = False                 # deepseek multi-token prediction head
    aux_loss_weight: float = 0.01
    mtp_loss_weight: float = 0.3
    dtype: torch.dtype = DEFAULT_DTYPE
    remat: str = "nothing_saveable"   # "none" | "nothing_saveable" | "dots"

    @property
    def n_units(self) -> int:
        body = self.n_layers - len(self.prelude)
        if body % len(self.pattern):
            raise ValueError(f"{self.name}: {body} layers not divisible by "
                             f"unit {len(self.pattern)}")
        return body // len(self.pattern)

    def mixer_cfg(self, mixer: str) -> AttentionConfig:
        if mixer == "attn_global" and self.attn_global is not None:
            return self.attn_global
        return self.attn


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _make_layer_params(gen: torch.Generator, cfg: ModelConfig,
                       spec: LayerSpec) -> dict:
    mixer, ffn = spec
    dev = init_device(gen)
    p: dict[str, Any] = {"norm1": norm_init(cfg.d_model, dev)}
    if mixer == "mamba":
        p["mixer"] = make_mamba_params(gen, cfg.mamba, cfg.dtype)
    else:
        p["mixer"] = make_attention_params(gen, cfg.mixer_cfg(mixer),
                                           cfg.dtype)
    if ffn != "none":
        p["norm2"] = norm_init(cfg.d_model, dev)
        if ffn == "moe":
            p["mlp"] = make_moe_params(gen, cfg.moe, cfg.dtype)
        else:
            p["mlp"] = make_mlp_params(gen, cfg.d_model, cfg.d_ff,
                                       cfg.gated_mlp, cfg.dtype)
    return p


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None,
                mesh=None):
    """Random parameters drawn from ``generator`` (on its device), placed on
    ``device`` (CUDA by default).  With ``mesh`` (the JAX package's
    ``jax.jit(init, out_shardings=...)``): every leaf is placed on its
    ``param_shardings(mode="train")`` placements as soon as it is drawn,
    and the whole leaf dropped, so a rank holds its shards and one whole
    leaf at most; the values are those drawn without a mesh, bit for
    bit (every rank draws every leaf from the same generator state, and
    keeps its shard)."""
    device = resolve_device(device)
    if mesh is not None:
        return _init_placed(generator, cfg, device, mesh)
    gen = generator
    vocab = cfg.vocab * cfg.codebooks
    params: dict[str, Any] = {
        "embed": embed_init(gen, vocab, cfg.d_model, cfg.dtype),
        "final_norm": norm_init(cfg.d_model, init_device(gen)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, vocab, cfg.d_model, cfg.dtype)
    params["prelude"] = [_make_layer_params(gen, cfg, s)
                         for s in cfg.prelude]
    params["units"] = [[_make_layer_params(gen, cfg, s) for s in cfg.pattern]
                       for _ in range(cfg.n_units)]
    if cfg.mtp:
        params["mtp"] = {
            "layer": _make_layer_params(gen, cfg, cfg.pattern[-1]),
            "norm": norm_init(cfg.d_model, init_device(gen)),
            "in_proj": embed_init(gen, 2 * cfg.d_model, cfg.d_model,
                                  cfg.dtype),
        }
    return _to(params, device)


def _init_placed(generator: torch.Generator, cfg: ModelConfig, device,
                 mesh):
    """:func:`init_params` on ``mesh``: a meta run gives the tree, its
    placements and the order the initialisers make its leaves in (each
    leaf known by identity); the real run places each leaf as it is
    made."""
    if generator.device.type != mesh.device_type or \
            device.type != mesh.device_type:
        raise ValueError(f"init_params: a {mesh.device_type} mesh, a "
                         f"generator on {generator.device} and device "
                         f"{device}")
    order: list[torch.Tensor] = []
    with meta_init(), on_leaf(lambda t: order.append(t) or t):
        shapes = init_params(torch.Generator(), cfg, "meta")
    leaves = pytree.tree_leaves(shapes)
    where = {id(t): i for i, t in enumerate(leaves)}
    if len(order) != len(leaves) or {id(t) for t in order} != set(where):
        raise RuntimeError(f"init_params: {len(leaves)} leaves, "
                           f"{len(order)} made by the initialisers")
    pls = pytree.tree_leaves(param_shardings(shapes, mesh, "train", cfg),
                             is_leaf=lambda x: isinstance(x, tuple))
    queue = iter([pls[where[id(t)]] for t in order])
    with on_leaf(lambda t: place_local(t, mesh, next(queue))):
        return init_params(generator, cfg, device)


def param_shapes(cfg: ModelConfig):
    """The parameter tree of ``cfg`` as meta tensors: every shape and dtype
    ``init_params`` makes, nothing allocated (deepseek-v3-671b's 1.3 TB
    cannot be drawn on a host)."""
    with meta_init():
        return init_params(torch.Generator(), cfg, "meta")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree if isinstance(tree, DTensor) else tree.to(device)


_IN_MESH_SCOPE = contextvars.ContextVar("in_mesh_scope", default=False)


@contextlib.contextmanager
def mesh_scope(t):
    """On a mesh (``t`` a DTensor), every plain tensor the model makes
    beside a DTensor (positions, masks, zeros, iotas, the modality stub's
    prefix) enters each op as the whole value, replicated on the DTensors'
    mesh.  Without a mesh this does nothing.  Scopes nest: the outermost
    one ends it (``implicit_replication`` alone would end at the first
    exit)."""
    if not isinstance(t, DTensor) or _IN_MESH_SCOPE.get():
        yield
        return
    token = _IN_MESH_SCOPE.set(True)
    try:
        with implicit_replication():
            yield
    finally:
        _IN_MESH_SCOPE.reset(token)


def _on_mesh(fn):
    """``fn(params, cfg, ...)`` in the mesh scope of its parameters."""
    @functools.wraps(fn)
    def wrapped(params, cfg, *args, **kwargs):
        with mesh_scope(params["embed"]):
            return fn(params, cfg, *args, **kwargs)
    return wrapped


# ---------------------------------------------------------------------------
# embedding and head
# ---------------------------------------------------------------------------

def _lookup(table, ids):
    """Rows ``ids`` of ``table`` by indexing, on one device and on a mesh
    alike.  On a mesh the index runs on each rank's local ids
    (``local_map``) into the whole table: the table's vocabulary shards
    are all-gathered first (one explicit redistribution; the gradient
    goes back as a reduce-scatter), and the rows are split like the
    ids."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    rep = (Replicate(),) * mesh.ndim
    if not isinstance(ids, DTensor):
        ids = distribute_tensor(ids, mesh, list(rep))
    lay = tuple(ids.placements)
    # each rank's rows come from its own ids: the table's gradient is a
    # partial sum over the axes that split them
    grad = tuple(Partial() if p.is_shard() else Replicate() for p in lay)
    rows = local_map(lambda t, i: t[i], out_placements=(lay,),
                     in_placements=(rep, lay), in_grad_placements=(grad, lay),
                     device_mesh=mesh)
    return rows(table.redistribute(mesh, rep), ids)


def _embed(params, cfg: ModelConfig, tokens):
    """tokens: [...] or [..., CB] (musicgen: per-codebook vocab offsets,
    summed embeddings).  Returns [..., D]."""
    if cfg.codebooks > 1:
        offs = torch.arange(cfg.codebooks, device=tokens.device) * cfg.vocab
        return _lookup(params["embed"], tokens + offs).sum(dim=-2)
    return _lookup(params["embed"], tokens)


def embed_tokens(params, cfg: ModelConfig, tokens, prefix_embeddings=None):
    """tokens: [B,S] or [B,S,CB] (musicgen).  Returns [B, n_prefix+S, D]."""
    x = _embed(params, cfg, tokens)
    if cfg.n_prefix:
        if prefix_embeddings is None:
            raise ValueError(f"{cfg.name}: needs prefix_embeddings "
                             f"[B, {cfg.n_prefix}, {cfg.d_model}]")
        x = torch.cat([prefix_embeddings.to(x.dtype), x], dim=1)
    return x


def logits_fn(params, cfg: ModelConfig, x):
    """[B,S,D] -> [B,S,V], or [B,S,CB,V] with codebooks."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.T
    if cfg.codebooks > 1:
        logits = split_last(logits, cfg.codebooks, cfg.vocab)
    return logits


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def _ffn(p, cfg: ModelConfig, ffn: str, x, h):
    """The layer's feed-forward half: the mixer's output ``h`` added into
    the stream ``x`` with the FFN's norm, the FFN's output the new pending
    ``h``.  Returns (x, h, aux), aux None but for an MoE layer; without an
    FFN the mixer's output stays pending."""
    if ffn == "none":
        return x, h, None
    x, n = ops.add_rmsnorm(x, h, p["norm2"])
    if ffn == "moe":
        h, aux = moe_apply(p["mlp"], cfg.moe, n)
        return x, h, aux
    return x, mlp_apply(p["mlp"], n), None


def _layer_forward(p, cfg: ModelConfig, spec: LayerSpec, x, h, positions):
    """One layer over the stream ``x`` with the previous branch output
    ``h`` still to be added (None: nothing pending); returns (x, h, aux),
    ``h`` this layer's last branch output, not yet added."""
    mixer, ffn = spec
    x, n = ops.add_rmsnorm(x, h, p["norm1"])
    if mixer == "mamba":
        h = mamba_forward(p["mixer"], cfg.mamba, n)
    elif mixer == "mla":
        h = mla_forward(p["mixer"], cfg.mixer_cfg(mixer), n, positions)
    else:
        h = gqa_forward(p["mixer"], cfg.mixer_cfg(mixer), n, positions)
    return _ffn(p, cfg, ffn, x, h)


def _unit_forward(unit_params, cfg: ModelConfig, x, h, positions):
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, spec in zip(unit_params, cfg.pattern):
        x, h, aux = _layer_forward(p, cfg, spec, x, h, positions)
        if aux is not None:
            aux_total = aux_total + aux
    return x, h, aux_total


# the products whose outputs the "dots" policy keeps for the backward
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, cfg: ModelConfig):
    """``fn`` recomputed in the backward: nothing saved
    (``"nothing_saveable"``) or the matmul outputs saved (``"dots"``).
    The forward draws no random numbers, so the RNG state is neither saved
    nor restored around the recompute (reading it would break a CUDA
    graph's capture of the step)."""
    if cfg.remat == "none":
        return fn
    kwargs = {"use_reentrant": False, "preserve_rng_state": False}
    if cfg.remat == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, **kwargs)


@_on_mesh
def forward(params, cfg: ModelConfig, tokens, prefix_embeddings=None):
    """Full forward -> (logits [B,S(+prefix),V] or [B,S(+prefix),CB,V], the
    MoE layers' summed aux (load-balancing) loss, final hidden)."""
    x = embed_tokens(params, cfg, tokens, prefix_embeddings)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    h = None
    for p, spec in zip(params["prelude"], cfg.prelude):
        x, h, aux = _layer_forward(p, cfg, spec, x, h, positions)
        if aux is not None:
            aux_total = aux_total + aux
    def unit(up, xx, hh):
        # in scope again when the backward recomputes the unit
        with mesh_scope(xx):
            return _unit_forward(up, cfg, xx, hh, positions)
    unit_fn = _remat_wrap(unit, cfg)
    for up in params["units"]:
        x, h, aux = unit_fn(up, x, h)
        aux_total = aux_total + aux
    _, x = ops.add_rmsnorm(x, h, params["final_norm"])
    return logits_fn(params, cfg, x), aux_total, x


@_on_mesh
def loss_fn(params, cfg: ModelConfig, batch):
    """batch: {"tokens": [B,S] or [B,S,CB], "labels": same,
    "prefix_embeddings": optional [B,P,D]} -> (total, metrics)."""
    logits, aux, x = forward(params, cfg, batch["tokens"],
                             batch.get("prefix_embeddings"))
    if cfg.n_prefix:
        logits = logits[:, cfg.n_prefix:]
    loss = cross_entropy_loss(logits, batch["labels"])
    total = loss + cfg.aux_loss_weight * aux
    if cfg.mtp and "mtp" in params:
        total = total + cfg.mtp_loss_weight * _mtp_loss(params, cfg, x, batch)
    return total, {"loss": loss, "aux": aux}


def _mtp_loss(params, cfg: ModelConfig, x, batch):
    """DeepSeek-V3 multi-token prediction: one extra layer predicts t+2 from
    (hidden_t ⊕ embed(token_{t+1}))."""
    mtp = params["mtp"]
    labels = batch["labels"]
    if cfg.codebooks > 1 or cfg.n_prefix:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    emb_next = _lookup(params["embed"], labels)          # labels = t+1
    h = torch.cat([x, emb_next.to(x.dtype)], dim=-1) @ mtp["in_proj"]
    positions = torch.arange(h.shape[1], device=h.device)
    h, pending, _ = _layer_forward(mtp["layer"], cfg, cfg.pattern[-1], h,
                                   None, positions)
    _, h = ops.add_rmsnorm(h, pending, mtp["norm"])
    logits2 = logits_fn(params, cfg, h)
    # predict t+2: shift labels by one more
    lab2 = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
    return cross_entropy_loss(logits2[:, :-1], lab2[:, :-1])


def param_count(params) -> int:
    return sum(t.numel() for t in pytree.tree_leaves(params))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _layer_prefill(p, cfg: ModelConfig, spec: LayerSpec, x, h, positions):
    """:func:`_layer_forward` of a prompt: returns (x, h, cache)."""
    mixer, ffn = spec
    x, n = ops.add_rmsnorm(x, h, p["norm1"])
    if mixer == "mamba":
        h, cache = mamba_prefill(p["mixer"], cfg.mamba, n)
    elif mixer == "mla":
        h, cache = mla_prefill(p["mixer"], cfg.mixer_cfg(mixer), n, positions)
    else:
        h, cache = gqa_prefill(p["mixer"], cfg.mixer_cfg(mixer), n, positions)
    return (*_ffn(p, cfg, ffn, x, h)[:2], cache)


def _pad_cache(cache, max_len: int):
    """Grow attention caches from prefill length to max_len (decode room)."""
    out = {}
    for k, v in cache.items():
        if k in ("k", "v", "c", "k_rope"):
            pad = [0, 0] * (v.dim() - 2) + [0, max_len - v.shape[1]]
            out[k] = F.pad(v, pad)
        else:
            out[k] = v
    return out


@_on_mesh
def prefill(params, cfg: ModelConfig, tokens, prefix_embeddings=None,
            max_len: int | None = None):
    """Run the prompt; returns (last_logits [B,V] or [B,CB,V], caches,
    length).  ``length`` counts the prefix positions too: the next token
    decodes at ``length``."""
    x = embed_tokens(params, cfg, tokens, prefix_embeddings)
    s = x.shape[1]
    max_len = max_len or s + 1
    positions = torch.arange(s, device=x.device)
    caches: dict[str, Any] = {"prelude": [], "units": []}
    h = None
    for p, spec in zip(params["prelude"], cfg.prelude):
        x, h, cache = _layer_prefill(p, cfg, spec, x, h, positions)
        caches["prelude"].append(_pad_cache(cache, max_len))
    for up in params["units"]:
        unit_caches = []
        for p, spec in zip(up, cfg.pattern):
            x, h, cache = _layer_prefill(p, cfg, spec, x, h, positions)
            unit_caches.append(_pad_cache(cache, max_len))
        caches["units"].append(unit_caches)
    _, x = ops.add_rmsnorm(x, h, params["final_norm"])
    logits = logits_fn(params, cfg, x[:, -1:])[:, 0]
    return logits, caches, s


def _layer_decode(p, cfg: ModelConfig, spec: LayerSpec, x, h, cache,
                  cache_len):
    """:func:`_layer_forward` of one token: returns (x, h, cache)."""
    mixer, ffn = spec
    x, n = ops.add_rmsnorm(x, h, p["norm1"])
    if mixer == "mamba":
        h, cache = mamba_decode(p["mixer"], cfg.mamba, n, cache)
    elif mixer == "mla":
        h, cache = mla_decode(p["mixer"], cfg.mixer_cfg(mixer), n, cache,
                              cache_len)
    else:
        h, cache = gqa_decode(p["mixer"], cfg.mixer_cfg(mixer), n, cache,
                              cache_len)
    return (*_ffn(p, cfg, ffn, x, h)[:2], cache)


@_on_mesh
def decode_step(params, cfg: ModelConfig, token, caches, cache_len):
    """One decode step.  token: [B] or [B,CB]; caches from prefill;
    cache_len: current length (prefix included), a Python int or a 0-d
    int64 tensor on the device, as the JAX package's jitted step takes a
    traced scalar (bitwise the same result; a captured step reads it
    there).  Returns (logits, caches): attention caches and Mamba's states
    are updated in place and returned as they came; on a mesh Mamba's
    states are each rank's written tensors, which may be new DTensors, so
    keep what is returned."""
    x = _embed(params, cfg, token)[:, None, :]
    new_caches: dict[str, Any] = {"prelude": [], "units": []}
    h = None
    for p, spec, cache in zip(params["prelude"], cfg.prelude,
                              caches["prelude"]):
        x, h, cache = _layer_decode(p, cfg, spec, x, h, cache, cache_len)
        new_caches["prelude"].append(cache)
    for up, unit_cache in zip(params["units"], caches["units"]):
        new_unit = []
        for p, spec, cache in zip(up, cfg.pattern, unit_cache):
            x, h, cache = _layer_decode(p, cfg, spec, x, h, cache,
                                        cache_len)
            new_unit.append(cache)
        new_caches["units"].append(new_unit)
    _, x = ops.add_rmsnorm(x, h, params["final_norm"])
    logits = logits_fn(params, cfg, x)[:, 0]
    return logits, new_caches
