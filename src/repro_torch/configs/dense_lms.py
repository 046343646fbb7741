"""Dense LM architectures: yi-6b, starcoder2-7b, stablelm-12b, gemma3-27b.

Sources: Yi [arXiv:2403.04652], StarCoder2 [arXiv:2402.19173],
StableLM-2 [hf:stabilityai/stablelm-2-1_6b scaled per assignment],
Gemma-3 [hf:google/gemma-3-1b-pt family; 27B per assignment].
"""
from repro_torch.configs.base import register, register_reduced
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.transformer import ModelConfig


@register("yi-6b")
def yi_6b() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", d_model=4096, n_layers=32, vocab=64000,
        pattern=(("attn", "dense"),),
        attn=AttentionConfig(d_model=4096, n_heads=32, n_kv_heads=4,
                             head_dim=128, rope_theta=5e6),
        d_ff=11008, gated_mlp=True, tie_embeddings=False,
    )


@register_reduced("yi-6b")
def yi_6b_reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-reduced", d_model=64, n_layers=2, vocab=256,
        pattern=(("attn", "dense"),),
        attn=AttentionConfig(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16),
        d_ff=128, gated_mlp=True, tie_embeddings=False,
    )


@register("starcoder2-7b")
def starcoder2_7b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", d_model=4608, n_layers=32, vocab=49152,
        pattern=(("attn", "dense"),),
        attn=AttentionConfig(d_model=4608, n_heads=36, n_kv_heads=4,
                             head_dim=128, rope_theta=1e5),
        d_ff=18432, gated_mlp=False,     # GPT-style GELU MLP
        tie_embeddings=False,
    )


@register_reduced("starcoder2-7b")
def starcoder2_7b_reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-reduced", d_model=72, n_layers=2, vocab=256,
        pattern=(("attn", "dense"),),
        attn=AttentionConfig(d_model=72, n_heads=6, n_kv_heads=2, head_dim=12),
        d_ff=288, gated_mlp=False, tie_embeddings=False,
    )


@register("stablelm-12b")
def stablelm_12b() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", d_model=5120, n_layers=40, vocab=100352,
        pattern=(("attn", "dense"),),
        attn=AttentionConfig(d_model=5120, n_heads=32, n_kv_heads=8,
                             head_dim=160, rope_theta=10000.0),
        d_ff=13824, gated_mlp=True, tie_embeddings=False,
    )


@register_reduced("stablelm-12b")
def stablelm_12b_reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b-reduced", d_model=80, n_layers=2, vocab=256,
        pattern=(("attn", "dense"),),
        attn=AttentionConfig(d_model=80, n_heads=4, n_kv_heads=2, head_dim=20),
        d_ff=160, gated_mlp=True, tie_embeddings=False,
    )


# Gemma-3 27B: 62 layers, 5 local (sliding window 1024) : 1 global,
# distinct rope theta for local (10k) vs global (1M) layers.
@register("gemma3-27b")
def gemma3_27b() -> ModelConfig:
    local = AttentionConfig(d_model=5376, n_heads=32, n_kv_heads=16,
                            head_dim=128, rope_theta=10000.0, window=1024)
    global_ = AttentionConfig(d_model=5376, n_heads=32, n_kv_heads=16,
                              head_dim=128, rope_theta=1e6)
    return ModelConfig(
        name="gemma3-27b", d_model=5376, n_layers=62, vocab=262144,
        prelude=(("attn_local", "dense"), ("attn_local", "dense")),
        pattern=(("attn_local", "dense"),) * 5 + (("attn_global", "dense"),),
        attn=local, attn_global=global_,
        d_ff=21504, gated_mlp=True, tie_embeddings=True,
    )


@register_reduced("gemma3-27b")
def gemma3_27b_reduced() -> ModelConfig:
    local = AttentionConfig(d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, window=32)
    global_ = AttentionConfig(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)
    return ModelConfig(
        name="gemma3-27b-reduced", d_model=64, n_layers=8, vocab=256,
        prelude=(("attn_local", "dense"), ("attn_local", "dense")),
        pattern=(("attn_local", "dense"),) * 5 + (("attn_global", "dense"),),
        attn=local, attn_global=global_,
        d_ff=128, gated_mlp=True, tie_embeddings=True,
    )
