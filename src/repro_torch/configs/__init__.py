"""Architecture config registry.  Importing registers all archs."""
from repro_torch.configs import (dense_lms, hybrid_ssm, moe_lms,  # noqa: F401
                                 multimodal)
from repro_torch.configs.base import (LONG_CONTEXT_ARCHS, SHAPES, ShapeSpec,
                                      cells, get_config, get_reduced_config,
                                      list_archs)

__all__ = ["LONG_CONTEXT_ARCHS", "SHAPES", "ShapeSpec", "cells",
           "get_config", "get_reduced_config", "list_archs"]
