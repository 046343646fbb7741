"""Multimodal backbones: musicgen-large [audio] and paligemma-3b [vlm]; the
modality frontend is a stub, as in the JAX package.

Sources: MusicGen [arXiv:2306.05284] — decoder-only over 4 EnCodec
codebooks (summed codebook embeddings, 4 parallel heads; the text/melody
conditioning frontend is stubbed as precomputed prefix embeddings).
PaliGemma [arXiv:2407.07726] — SigLIP patches (stubbed as 256 precomputed
patch embeddings) + Gemma-2B-class decoder.
"""
from repro_torch.configs.base import register, register_reduced
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.transformer import ModelConfig


@register("musicgen-large")
def musicgen() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", d_model=2048, n_layers=48, vocab=2048,
        pattern=(("attn", "dense"),),
        attn=AttentionConfig(d_model=2048, n_heads=32, n_kv_heads=32,
                             head_dim=64, rope_theta=10000.0),
        d_ff=8192, gated_mlp=False,       # standard GELU transformer
        codebooks=4,
        n_prefix=64,                      # conditioning stub (text/melody)
        tie_embeddings=False,
    )


@register_reduced("musicgen-large")
def musicgen_reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-reduced", d_model=64, n_layers=2, vocab=128,
        pattern=(("attn", "dense"),),
        attn=AttentionConfig(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16),
        d_ff=128, gated_mlp=False, codebooks=4, n_prefix=8,
        tie_embeddings=False,
    )


@register("paligemma-3b")
def paligemma() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", d_model=2048, n_layers=18, vocab=257216,
        pattern=(("attn", "dense"),),
        attn=AttentionConfig(d_model=2048, n_heads=8, n_kv_heads=1,
                             head_dim=256, rope_theta=10000.0),
        d_ff=16384, gated_mlp=True,
        n_prefix=256,                     # SigLIP patch-embedding stub
        tie_embeddings=True,
    )


@register_reduced("paligemma-3b")
def paligemma_reduced() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b-reduced", d_model=64, n_layers=2, vocab=256,
        pattern=(("attn", "dense"),),
        attn=AttentionConfig(d_model=64, n_heads=4, n_kv_heads=1, head_dim=16),
        d_ff=128, gated_mlp=True, n_prefix=16, tie_embeddings=True,
    )
