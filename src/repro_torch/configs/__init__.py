"""Architecture config registry.  Importing registers the ported archs:
the dense LMs and mamba2-1.3b (jamba, the MoE LMs and the multimodal
stubs wait for the MoE slice)."""
from repro_torch.configs import dense_lms, hybrid_ssm  # noqa: F401
from repro_torch.configs.base import (SHAPES, ShapeSpec, get_config,
                                      get_reduced_config)

__all__ = ["SHAPES", "ShapeSpec", "get_config", "get_reduced_config"]
