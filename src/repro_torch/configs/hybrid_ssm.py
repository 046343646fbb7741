"""SSM architectures: mamba2-1.3b.

Source: Mamba-2 [arXiv:2405.21060] — pure SSD stack.  (The JAX package's
hybrid jamba-1.5-large-398b waits for the MoE slice.)
"""
from repro_torch.configs.base import register, register_reduced
from repro_torch.models.mamba import MambaConfig
from repro_torch.models.transformer import ModelConfig


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
