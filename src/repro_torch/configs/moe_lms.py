"""MoE architectures: deepseek-v3-671b, arctic-480b.

Sources: DeepSeek-V3 [arXiv:2412.19437] — MLA, 1 shared + 256 routed top-8,
sigmoid router, first 3 layers dense, MTP.  Snowflake Arctic
[hf:Snowflake/snowflake-arctic-base] — 128 experts top-2 with a dense
residual MLP in parallel (modeled as a shared-expert branch).
"""
from repro_torch.configs.base import register, register_reduced
from repro_torch.models.attention import AttentionConfig, MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig


@register("deepseek-v3-671b")
def deepseek_v3() -> ModelConfig:
    attn = AttentionConfig(
        d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
        rope_theta=10000.0,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    )
    moe = MoEConfig(
        d_model=7168, n_experts=256, top_k=8, d_ff_expert=2048,
        n_shared_experts=1, d_ff_shared=2048,
        sigmoid_router=True, capacity_factor=1.25,
    )
    return ModelConfig(
        name="deepseek-v3-671b", d_model=7168, n_layers=61, vocab=129280,
        prelude=(("mla", "dense"),) * 3,
        pattern=(("mla", "moe"),),
        attn=attn, moe=moe,
        d_ff=18432, gated_mlp=True, tie_embeddings=False, mtp=True,
    )


@register_reduced("deepseek-v3-671b")
def deepseek_v3_reduced() -> ModelConfig:
    attn = AttentionConfig(
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                      rope_head_dim=8, nope_head_dim=16, v_head_dim=16),
    )
    moe = MoEConfig(d_model=64, n_experts=8, top_k=2, d_ff_expert=32,
                    n_shared_experts=1, d_ff_shared=32, sigmoid_router=True,
                    capacity_factor=8.0)
    return ModelConfig(
        name="deepseek-v3-671b-reduced", d_model=64, n_layers=4, vocab=256,
        prelude=(("mla", "dense"),),
        pattern=(("mla", "moe"),),
        attn=attn, moe=moe,
        d_ff=128, gated_mlp=True, tie_embeddings=False, mtp=True,
    )


@register("arctic-480b")
def arctic() -> ModelConfig:
    attn = AttentionConfig(d_model=7168, n_heads=56, n_kv_heads=8,
                           head_dim=128, rope_theta=10000.0)
    # dense-MoE hybrid: 128 routed experts + parallel dense residual branch
    moe = MoEConfig(d_model=7168, n_experts=128, top_k=2, d_ff_expert=4864,
                    n_shared_experts=1, d_ff_shared=4864,
                    capacity_factor=1.25)
    return ModelConfig(
        name="arctic-480b", d_model=7168, n_layers=35, vocab=32000,
        pattern=(("attn", "moe"),),
        attn=attn, moe=moe,
        d_ff=4864, gated_mlp=True, tie_embeddings=False,
    )


@register_reduced("arctic-480b")
def arctic_reduced() -> ModelConfig:
    attn = AttentionConfig(d_model=64, n_heads=8, n_kv_heads=2, head_dim=8)
    moe = MoEConfig(d_model=64, n_experts=8, top_k=2, d_ff_expert=32,
                    n_shared_experts=1, d_ff_shared=32, capacity_factor=8.0)
    return ModelConfig(
        name="arctic-480b-reduced", d_model=64, n_layers=2, vocab=256,
        pattern=(("attn", "moe"),),
        attn=attn, moe=moe, d_ff=32, gated_mlp=True, tie_embeddings=False,
    )
