from repro_torch.configs.base import (
    ARCH_IDS,
    LONG_CONTEXT_ARCHS,
    SHAPES,
    SHAPE_BY_NAME,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    cell_is_runnable,
    get_config,
    get_smoke_config,
    runnable_cells,
    scaled_config,
)

__all__ = [
    "ARCH_IDS", "LONG_CONTEXT_ARCHS", "SHAPES", "SHAPE_BY_NAME",
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "cell_is_runnable", "get_config", "get_smoke_config",
    "runnable_cells", "scaled_config",
]
