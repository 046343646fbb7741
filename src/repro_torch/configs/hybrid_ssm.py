"""Hybrid and SSM architectures: jamba-1.5-large-398b, mamba2-1.3b.

Sources: Jamba-1.5 [arXiv:2403.19887 / 2408.12570] — 1:7 attention:mamba
interleave, MoE 16 experts top-2 every other layer.  Mamba-2
[arXiv:2405.21060] — pure SSD stack.

Jamba ships Mamba-1 internally; the JAX package uses the Mamba-2 SSD
formulation in its place (chunked matmuls), and so does the port.
"""
from repro_torch.configs.base import register, register_reduced
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.mamba import MambaConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig


def _jamba_unit():
    """8-layer Jamba period: attention at index 4, MoE on odd layers."""
    unit = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        unit.append((mixer, ffn))
    return tuple(unit)


@register("jamba-1.5-large-398b")
def jamba() -> ModelConfig:
    attn = AttentionConfig(d_model=8192, n_heads=64, n_kv_heads=8,
                           head_dim=128, rope_theta=10000.0)
    mamba = MambaConfig(d_model=8192, d_state=128, head_dim=128, expand=2,
                        d_conv=4, n_groups=1, chunk_size=256)
    moe = MoEConfig(d_model=8192, n_experts=16, top_k=2, d_ff_expert=24576,
                    capacity_factor=1.25)
    return ModelConfig(
        name="jamba-1.5-large-398b", d_model=8192, n_layers=72, vocab=65536,
        pattern=_jamba_unit(),      # 9 units × 8 layers
        attn=attn, mamba=mamba, moe=moe,
        d_ff=24576, gated_mlp=True, tie_embeddings=False,
    )


@register_reduced("jamba-1.5-large-398b")
def jamba_reduced() -> ModelConfig:
    attn = AttentionConfig(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)
    mamba = MambaConfig(d_model=64, d_state=16, head_dim=16, expand=2,
                        d_conv=4, n_groups=1, chunk_size=16)
    moe = MoEConfig(d_model=64, n_experts=4, top_k=2, d_ff_expert=64,
                    capacity_factor=8.0)
    return ModelConfig(
        name="jamba-1.5-large-398b-reduced", d_model=64, n_layers=8,
        vocab=256, pattern=_jamba_unit(),
        attn=attn, mamba=mamba, moe=moe,
        d_ff=64, gated_mlp=True, tie_embeddings=False,
    )


@register("mamba2-1.3b")
def mamba2() -> ModelConfig:
    mamba = MambaConfig(d_model=2048, d_state=128, head_dim=64, expand=2,
                        d_conv=4, n_groups=1, chunk_size=256)
    return ModelConfig(
        name="mamba2-1.3b", d_model=2048, n_layers=48, vocab=50280,
        pattern=(("mamba", "none"),),
        mamba=mamba, d_ff=0, tie_embeddings=True,
    )


@register_reduced("mamba2-1.3b")
def mamba2_reduced() -> ModelConfig:
    mamba = MambaConfig(d_model=64, d_state=16, head_dim=16, expand=2,
                        d_conv=4, n_groups=1, chunk_size=16)
    return ModelConfig(
        name="mamba2-1.3b-reduced", d_model=64, n_layers=4, vocab=256,
        pattern=(("mamba", "none"),),
        mamba=mamba, d_ff=0, tie_embeddings=True,
    )
