"""Config registry: arch id -> ArchConfig."""
from . import (dbrx_132b, gemma3_4b, granite_20b, granite_8b,
               granite_moe_3b, hymba_1_5b, internvl2_26b, mamba2_130m,
               musicgen_large, qwen2_72b)
from .base import SHAPES, ArchConfig, ShapeConfig, shapes_for, smoke_config
from .specfam import SPEC_FAMILIES, family_specs

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_72b, granite_8b, gemma3_4b, granite_20b,
              musicgen_large, granite_moe_3b, dbrx_132b, hymba_1_5b,
              internvl2_26b, mamba2_130m)
}

__all__ = ["ARCHS", "SHAPES", "SPEC_FAMILIES", "ArchConfig", "ShapeConfig",
           "family_specs", "shapes_for", "smoke_config"]
